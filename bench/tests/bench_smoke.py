"""The benchmark's cells at a size the CPU tests hold, found by name like
the harness finds them: a configuration's sizes in
``bench/tests/smoke/configs/<config>.json``, whose ``smoke`` block cuts the
configuration's file to the port's smoke size and whose ``control`` block,
laid over ``smoke``, to the size the control test reads; and each mix's
few short requests on a few slots in ``bench/tests/smoke/traffic/<mix>.json``.
A cell that a later change adds enters these tests by adding those files
(``test_bench_smoke_files.py`` asks for them). Also a virtual clock, so
that a test serves the same work however loaded the host is, and the
control test that each cell's own file runs. Importing it puts the
repository and the port's ``src/`` on the path."""
from __future__ import annotations

import copy
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):            # the benchmark and the port
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: the sized files: ``configs/<config>.json`` and ``traffic/<mix>.json``
SIZED = Path(__file__).resolve().parent / "smoke"
SIZES = ("smoke", "control")


def _benchmark(bench: Optional[Dict]) -> Dict:
    if bench is None:
        return json.loads((ROOT / "BENCHMARK.json").read_text())
    return bench


def _sized(path: Path, what: str) -> Dict:
    if not path.exists():
        raise FileNotFoundError(f"{path}: add it, {what}")
    return json.loads(path.read_text())


def sizes(name: str, sized: Path = SIZED) -> Dict:
    """The sized file of configuration ``name``."""
    return _sized(sized / "configs" / f"{name}.json",
                  "with blocks " + " and ".join(SIZES) + ", each giving "
                  "the file's keys to replace (config) and the port's "
                  "fields to replace (port_fields)")


def config(name: str = "yi-9b", size: str = "smoke",
           bench: Optional[Dict] = None, root: Path = ROOT,
           sized: Path = SIZED) -> Dict:
    """The file of configuration ``name`` with its ``smoke`` block laid
    over it and, for ``size="control"``, its ``control`` block over that."""
    entry = next(c for c in _benchmark(bench)["configs"]
                 if c["name"] == name)
    conf = json.loads((root / entry["file"]).read_text())
    blocks = sizes(name, sized)
    for block in SIZES[:SIZES.index(size) + 1]:
        conf.update(blocks[block]["config"])
        conf["port"]["fields"].update(blocks[block]["port_fields"])
    return conf


def setup(tmp: Path, size: str = "smoke", bench: Optional[Dict] = None,
          root: Path = ROOT, sized: Path = SIZED):
    """(root, bench) in which each configuration of ``BENCHMARK.json``
    (or of ``bench``) is its file at ``size``, written under ``tmp``."""
    bench = copy.deepcopy(_benchmark(bench))
    for c in bench["configs"]:
        (tmp / f"{c['name']}.json").write_text(json.dumps(
            config(c["name"], size, bench, root, sized)))
        c["file"] = f"{c['name']}.json"
    return tmp, bench


def overlay(cell: str, bench: Optional[Dict] = None,
            sized: Path = SIZED) -> Dict:
    """The smoke traffic of the mix that ``cell`` serves."""
    mix = next(w for w in _benchmark(bench)["workloads"]
               if w["name"] == cell)["traffic"]
    return _sized(sized / "traffic" / f"{mix}.json",
                  "the numbers of the mix to replace for a few short "
                  "requests on a few slots")


def control_file(cell: str) -> str:
    """The name of the file that runs ``cell``'s control test."""
    return f"test_bench_control_{re.sub(r'[^A-Za-z0-9]', '_', cell)}.py"


class VirtualClock:
    """Seconds that pass only when the harness sleeps or the server ticks
    (``tick`` seconds a tick)."""

    def __init__(self, tick: float):
        self.now, self.tick = 0.0, tick

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, seconds)


def virtual_time(monkeypatch, server_cls=None, tick: float = 0.1):
    """``server_cls`` (the port's ``Server`` by default) on a
    :class:`VirtualClock`, which the harness's window reads too."""
    from types import SimpleNamespace

    from bench.harness import serve
    from repro_torch.runtime.server import Server

    clock = VirtualClock(tick)
    monkeypatch.setattr(serve, "time", SimpleNamespace(
        perf_counter=clock, sleep=clock.sleep))

    class OnClock(server_cls or Server):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, clock=clock, **kwargs)

        def step(self):
            super().step()
            clock.now += clock.tick

    return OnClock


def control_readings(tmp: Path, cell: str, monkeypatch,
                     seeds: Iterable[int] = (1, 2, 3, 4, 5),
                     size: str = "control", bench: Optional[Dict] = None,
                     root: Path = ROOT, sized: Path = SIZED) -> List[Dict]:
    """``bench/control.py``'s readings of ``cell`` at ``size``: the mix's
    smoke traffic served for 3 s on a virtual clock (the same tokens
    however loaded the host; the control's misses are read at served
    positions only) and judged over up to 320 served tokens."""
    import torch

    from bench import control

    root, bench = setup(tmp, size, bench, root, sized)
    ov = dict(overlay(cell, bench, sized), check_tokens=320)
    # one intra-op thread: beside each other on the test run's workers,
    # two control files at torch's default of a thread a core took over
    # 15 minutes on an 8-core host, and 22 s at one thread each
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return list(control.readings(
            cell, list(seeds), 3.0, "cpu", root=root, bench=bench,
            overlay=ov, server_cls=virtual_time(monkeypatch)))
    finally:
        torch.set_num_threads(threads)


def control_cell(test_file: str) -> str:
    """The cell whose control test ``test_file`` is, by its name."""
    name = Path(test_file).name
    for w in _benchmark(None)["workloads"]:
        if control_file(w["name"]) == name:
            return w["name"]
    raise LookupError(f"{name}: names no cell of BENCHMARK.json")


def control_case(tmp: Path, test_file: str, monkeypatch) -> None:
    """The control of the cell that ``test_file`` is named after (see
    :func:`control_file`) comes out not correct: the reference computed with
    float8 products put in the program's place reads a widest gap over
    the cell's limit, where the program's own runs read under it. At the
    configuration's ``control`` size (for Yi-9B its 48 layers at width
    128: depth is what carries float8's rounding into the logits). At
    this size a control can read under the limit (0.19 of 0.25 once in
    eight seeds, on the host clock); on the card at the cells' own size
    every control read at least 1.8 times the limit (PERF.md,
    ``bench/control.py``). So it is asked of most seeds."""
    rows = control_readings(tmp, control_cell(test_file), monkeypatch)
    for r in rows:
        assert r["failed"] == 0 and r["tokens"] >= 100, r
        assert r["program_gap"] <= r["limit"], r
    assert sum(r["control_gap"] > r["limit"] for r in rows) >= 3, rows
