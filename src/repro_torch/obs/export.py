"""RunTrace — the per-run observability artifact written next to the
``Deployment.save`` bundle (port of ``repro/obs/export.py``; host code).

A :class:`RunTrace` freezes one run's spans and metric snapshot into a
saveable artifact:

* ``trace.json``   — Chrome trace-event JSON (open in Perfetto);
* ``trace.jsonl``  — one span per line for line-oriented tooling;
* ``metrics.json`` — the registry snapshot (counters/gauges/histograms);
* ``summary.txt``  — the human-readable table printed by :meth:`summary`.

:class:`capture` is the one-liner entry point: it installs a fresh enabled
tracer + registry as the process defaults for the ``with`` body, then
restores the previous ones and leaves the finished :class:`RunTrace` on
``cap.trace``::

    with obs.capture("workflow") as cap:
        wf.run_once(knobs)
    cap.trace.save(build_dir)
    print(cap.trace.summary())
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import (MetricsRegistry, get_metrics,
                                     set_metrics)
from repro_torch.obs.trace import (Span, Tracer, get_tracer, set_tracer,
                                   span_tree, to_chrome_trace, to_jsonl)

__all__ = ["RunTrace", "capture"]


@dataclass
class RunTrace:
    """One run's spans + metrics, as a saveable artifact."""

    name: str
    spans: List[Span] = field(default_factory=list)
    metrics: Dict[str, dict] = field(default_factory=dict)

    @classmethod
    def from_tracer(cls, name: str, tracer: Optional[Tracer] = None,
                    metrics: Optional[MetricsRegistry] = None) -> "RunTrace":
        tracer = tracer if tracer is not None else get_tracer()
        metrics = metrics if metrics is not None else get_metrics()
        return cls(name=name, spans=list(tracer.spans),
                   metrics=metrics.snapshot())

    def chrome(self) -> dict:
        return to_chrome_trace(self.spans)

    def jsonl(self) -> str:
        return to_jsonl(self.spans)

    def summary(self, max_depth: int = 4) -> str:
        """Human-readable span tree + metric table (what CI logs show)."""
        lines = [f"RunTrace {self.name!r}: {len(self.spans)} spans, "
                 f"{len(self.metrics)} metrics"]
        tree = span_tree(self.spans)
        if tree:
            lines.append(f"{'span':<48} {'ms':>10} {'attrs'}")
            for s, depth in tree:
                if depth > max_depth:
                    continue
                label = "  " * depth + s.name
                attrs = " ".join(f"{k}={v}" for k, v in sorted(
                    s.attrs.items()))
                lines.append(f"{label:<48} {s.duration * 1e3:>10.3f} "
                             f"{attrs}".rstrip())
        if self.metrics:
            lines.append("")
            lines.append(f"{'metric':<44} {'value'}")
            for name, snap in self.metrics.items():
                kind = snap.get("type")
                if kind == "counter":
                    val = str(snap["value"])
                elif kind == "gauge":
                    val = (f"last={snap['value']:g} min={snap['min']:g} "
                           f"max={snap['max']:g}"
                           if snap["n"] else "unset")
                else:
                    val = (f"n={snap['count']} mean={snap['mean']:.3g} "
                           f"p50={snap['p50']:.3g} p95={snap['p95']:.3g} "
                           f"p99={snap['p99']:.3g}")
                lines.append(f"{name:<44} {val}")
        return "\n".join(lines)

    def save(self, build_dir: str) -> Dict[str, str]:
        """Write the artifact files into ``build_dir``; returns the paths."""
        os.makedirs(build_dir, exist_ok=True)
        paths = {
            "trace.json": os.path.join(build_dir, "trace.json"),
            "trace.jsonl": os.path.join(build_dir, "trace.jsonl"),
            "metrics.json": os.path.join(build_dir, "metrics.json"),
            "summary.txt": os.path.join(build_dir, "summary.txt"),
        }
        with open(paths["trace.json"], "w") as f:
            json.dump(self.chrome(), f, indent=2, sort_keys=True)
        with open(paths["trace.jsonl"], "w") as f:
            f.write(self.jsonl())
        with open(paths["metrics.json"], "w") as f:
            json.dump(self.metrics, f, indent=2, sort_keys=True)
        with open(paths["summary.txt"], "w") as f:
            f.write(self.summary() + "\n")
        return paths


class capture:
    """Enable tracing + fresh metrics for a ``with`` body; yields itself,
    with the finished :class:`RunTrace` on ``.trace`` after exit. The
    previously-installed tracer/registry are restored on the way out, so a
    capture never leaks an enabled tracer into later code."""

    def __init__(self, name: str = "run",
                 clock: Optional[Callable[[], float]] = None):
        self.name = name
        self._clock = clock
        self.tracer: Optional[Tracer] = None
        self.metrics: Optional[MetricsRegistry] = None
        self.trace: Optional[RunTrace] = None

    def __enter__(self) -> "capture":
        kw = {"clock": self._clock} if self._clock is not None else {}
        self.tracer = Tracer(enabled=True, **kw)
        self.metrics = MetricsRegistry()
        self._prev_tracer = set_tracer(self.tracer)
        self._prev_metrics = set_metrics(self.metrics)
        return self

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev_tracer)
        set_metrics(self._prev_metrics)
        self.trace = RunTrace(name=self.name, spans=list(self.tracer.spans),
                              metrics=self.metrics.snapshot())
        return False
