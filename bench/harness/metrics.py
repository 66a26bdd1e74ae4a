"""The metrics of a run, each read by its own reader,
``bench/metrics/<name>.py``, whose ``read(reading)`` returns the number or,
where it finds nothing to read, None (the metric is then left out of the
line). End-to-end metrics are read from the untraced run's host clock over
the whole window (``--trace 0``); per-layer metrics from the traced run's
spans, stamps and device trace (``--trace 1``)."""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

from bench.harness.serve import Run
from bench.harness.spec import BENCH


@dataclass
class Reading:
    """What a reader reads: the run, the configuration's file and its
    plain reference module (whose ``prefill_flops``/``decode_flops`` count
    the model's work)."""

    run: Run
    config: Dict
    model: ModuleType

    def spans(self, name: str) -> List:
        """The spans ``name`` that ended inside the window."""
        return [s for s in self.run.spans
                if s.name == name and self.run.t0 <= s.end <= self.run.t1]


def reader(name: str) -> ModuleType:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(metrics: List[Dict], reading: Reading) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
