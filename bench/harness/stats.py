"""The end-to-end arithmetic: percentiles, time to first token, the gaps
between tokens and tokens per second, each over all the requests and
tokens of the measured window ``[t0, t1]`` (host clock, seconds)."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0..100), interpolated linearly between the
    order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(dues: Iterable[float], firsts: Iterable[Optional[float]],
          t0: float, t1: float) -> List[float]:
    """Seconds from due to first token of every request due in the window;
    a request with no first token by ``t1`` counts as ``t1 - due``, so a
    stall cannot hide."""
    out = []
    for due, first in zip(dues, firsts):
        if not t0 <= due <= t1:
            continue
        out.append((first if first is not None and first <= t1 else t1) - due)
    return out


def gaps(stamps: Iterable[Sequence[float]], t0: float,
         t1: float) -> List[float]:
    """Every gap between two consecutive tokens of one request, both
    emitted in the window."""
    out = []
    for s in stamps:
        inside = [t for t in s if t0 <= t <= t1]
        out.extend(b - a for a, b in zip(inside, inside[1:]))
    return out


def tokens_in(stamps: Iterable[Sequence[float]], t0: float, t1: float) -> int:
    return sum(sum(1 for t in s if t0 <= t <= t1) for s in stamps)
