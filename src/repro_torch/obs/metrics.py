"""Named counters, gauges and latency histograms — the metrics half.

Spans answer "where did this run spend its time"; metrics answer "how often
and how much" across a whole run: program-cache hits vs misses, per-mode
dispatch counts, queue depth per server tick, per-request latency
distributions. Deployment readiness is a *tail*-latency question (Venieris
et al. 2018), so histograms keep every observation and summarize as
p50/p95/p99, not just a mean.

Instruments:

* :class:`Counter`   — monotonically increasing count (``inc``);
* :class:`Gauge`     — last value plus running min/max (``set``);
* :class:`Histogram` — all observations (``observe``), percentile
  summaries interpolated the same way as ``numpy.percentile``'s default
  linear method (tested against it).

A :class:`MetricsRegistry` is a get-or-create namespace of instruments with
a single ``snapshot()`` for export. Components that own their metrics
(the Server) hold their own registry; pipeline-wide instrumentation
(emulator cache, verify, measure) records into the process-default registry
(:func:`get_metrics`), swappable for test isolation via
:func:`set_metrics`. Everything is plain Python ints/floats/lists — cost
per update is a dict lookup and an append, cheap enough to stay always-on
outside the innermost dispatch loops.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_metrics", "set_metrics", "percentile",
]


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile with linear interpolation (numpy's default).

    ``p`` in [0, 100]. Empty input returns 0.0 rather than raising so a
    summary of an untouched histogram stays well-formed.
    """
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("name", "value", "min", "max", "n")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.n = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.n += 1

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value, "min": self.min,
                "max": self.max, "n": self.n}


class Histogram:
    """Keeps every observation; summaries are exact order statistics."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.values else 0.0

    def percentile(self, p: float) -> float:
        return percentile(self.values, p)

    def summary(self) -> dict:
        vs = self.values
        return {
            "count": len(vs),
            "sum": float(sum(vs)),
            "mean": self.mean,
            "min": float(min(vs)) if vs else 0.0,
            "max": float(max(vs)) if vs else 0.0,
            "p50": percentile(vs, 50),
            "p95": percentile(vs, 95),
            "p99": percentile(vs, 99),
        }

    def snapshot(self) -> dict:
        return {"type": "histogram", **self.summary()}


class MetricsRegistry:
    """Get-or-create namespace of instruments, one ``snapshot()`` out."""

    __slots__ = ("counters", "gauges", "histograms")

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> Dict[str, dict]:
        """``{metric name: snapshot dict}``, sorted for stable artifacts."""
        out: Dict[str, dict] = {}
        for group in (self.counters, self.gauges, self.histograms):
            for name, inst in group.items():
                out[name] = inst.snapshot()
        return dict(sorted(out.items()))

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


#: Process default — pipeline-wide instrumentation records here.
_METRICS = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _METRICS


def set_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process default; returns the previous."""
    global _METRICS
    prev = _METRICS
    _METRICS = registry
    return prev
