"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration's file (``bench/configs/<config>.json``), its traffic
mix (``bench/traffic/<traffic>.json``) with the cell's own numbers
(``bench/cells/<cell>.json``, where there is one) laid over it, and the
metrics ``BENCHMARK.json`` gives the cell."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _listed(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT, bench: Optional[Dict] = None,
         overlay: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``);
    ``overlay`` replaces numbers of its mix (the knee sweep's rates)."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    own = BENCH / "cells" / f"{name}.json"
    if own.exists():
        mix.update(json.loads(own.read_text()))
    mix.update(overlay or {})
    return Cell(name=name, chips=entry["chips"], config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _listed(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _listed(m, name)])
