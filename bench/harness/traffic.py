"""The one traffic generator: a mix's parameters (``bench/traffic/<mix>.json``,
with the cell's own numbers from ``bench/cells/<cell>.json`` laid over
them) and a seed give the requests of a run.

Every seed gets the same work at the same times. Prompt and output
lengths, and an open loop's gaps between arrivals, are the quantiles of
their distributions at ``(i + 1/2) / n``, shuffled once by the mix's own
``schedule_seed``; the run's seed draws the prompts' token ids (and the
weights). An order drawn from the run's seed moved a 56-request window's
p90 time to first token by up to 40% between seeds (PERF.md), where two
runs of one seed moved it by 6-12%: the schedule is part of the mix, the
content the seed's.

Two loops:

* ``open``: ``n = round(rate * seconds)`` requests, each due at its
  scheduled time, sent whatever the system does (independent users);
* ``closed``: ``clients`` users, each sending its next request when its
  reply is done; the pool opens on each client's first request. With
  ``part_way``, the pool opens as a steady closed loop holds it: each
  first request is drawn in proportion to its output length (a long reply
  holds its slot longer) and comes part-way through that output, a share
  of it (the quantiles of a uniform share, in the mix's order) already
  served, its tokens drawn at the end of the prompt. So contexts span the
  mix, replies finish and the loop sends new prompts inside the window.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Req:
    """One request of the traffic: its prompt, how many tokens it asks
    for, when it is due (seconds after the window opens; None in a closed
    loop, where a client sends it) and which client sends it."""

    prompt: List[int]
    out_len: int
    due: Optional[float] = None
    client: Optional[int] = None
    head: int = 0       # output tokens served before the window, in prompt


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """``n`` lengths: ``dist``'s quantiles at ``(i + 1/2) / n``, as whole
    numbers within its ``min`` and ``max``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        x = lo + u * (hi - lo + 1)
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
        return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def length_biased(dist: Dict, n: int) -> np.ndarray:
    """``n`` lengths of ``dist`` weighted by their size: the quantiles at
    ``(i + 1/2) / n`` of the lengths that a steady pool holds."""
    grid = quantiles(dist, 4096)
    cdf = np.cumsum(grid) / grid.sum()
    u = (np.arange(n) + 0.5) / n
    return grid[np.minimum(np.searchsorted(cdf, u), len(grid) - 1)]


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps between Poisson arrivals at ``rate`` per second: the
    exponential distribution's quantiles at ``(i + 1/2) / n``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def _prompt(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    # ids 2.. : 0 and 1 are the usual pad and eos ids
    return rng.integers(2, vocab, n).tolist()


def generate(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Req]:
    """The run's requests, in the order they are sent (open loop) or, for
    a closed loop, client ``c``'s ``k``-th request at index
    ``k * clients + c``."""
    order = np.random.default_rng(mix.get("schedule_seed", 0))
    rng = np.random.default_rng(seed)
    if mix["loop"] == "open":
        rounds, size = 1, max(1, round(mix["rate_per_s"] * seconds))
    elif mix["loop"] == "closed":
        # a round is one request of each client: every round holds the
        # same lengths, so the pool opens on the same work for every seed
        rounds, size = mix["requests_per_client"], mix["clients"]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    count = rounds * size
    prompts = np.concatenate([order.permutation(
        quantiles(mix["prompt"], size)) for _ in range(rounds)])
    outs = np.concatenate([order.permutation(quantiles(mix["output"], size))
                           for _ in range(rounds)])
    due = None
    if mix["loop"] == "open":
        due = np.cumsum(order.permutation(exp_gaps(mix["rate_per_s"],
                                                   count)))
    heads = np.zeros(count, np.int64)
    if mix.get("part_way"):
        outs[:size] = order.permutation(length_biased(mix["output"], size))
        share = order.permutation((np.arange(size) + 0.5) / size)
        heads[:size] = np.floor(share * outs[:size]).astype(np.int64)
    if (prompts + outs > mix["max_len"]).any():
        raise ValueError(f"a prompt and its output exceed {mix['max_len']}"
                         " tokens")
    reqs = []
    for i in range(count):
        reqs.append(Req(
            prompt=_prompt(rng, int(prompts[i] + heads[i]), vocab),
            out_len=int(outs[i] - heads[i]),
            due=None if due is None else float(due[i]),
            client=None if due is not None else i % mix["clients"],
            head=int(heads[i])))
    return reqs


def warm_lengths(mix: Dict) -> List[int]:
    """The prompt lengths set-up prefills once: the shortest, the median
    and the longest the mix draws."""
    q = quantiles(mix["prompt"], 101)
    return sorted({int(q[0]), int(q[50]), int(q[-1])})

