"""A configuration enters the benchmark's CPU tests by new files alone: a
copy of ``yi-9b`` under another name, with a cell of its own on
``long_prompt``, its file, its cell's numbers and its sized file laid
beside the benchmark's own in ``tmp_path``, runs at the smoke size, is
correct, reports the metrics listed for it, and is taken by the control
test's readings."""
from __future__ import annotations

import json
import math
import shutil

import pytest

import bench_smoke
from bench import run as bench_run

NAME = "yi-9b-copy"
CELL = f"{NAME}.long_prompt"
LIKE = "yi-9b.long_prompt"


@pytest.fixture
def second(tmp_path, monkeypatch):
    """(run directory, bench, root, sized files) with the copy's config,
    cell and metrics' ``workloads`` added, and its files written only
    under ``tmp_path``."""
    from bench.harness import metrics, spec

    bench = json.loads((bench_smoke.ROOT / "BENCHMARK.json").read_text())
    root, sized = tmp_path / "root", tmp_path / "sized"
    data = root / "bench"
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(spec.BENCH / d, data / d)
    shutil.copytree(bench_smoke.SIZED, sized)
    entry = next(c for c in bench["configs"] if c["name"] == "yi-9b")
    conf = json.loads((bench_smoke.ROOT / entry["file"]).read_text())
    (data / "configs" / f"{NAME}.json").write_text(
        json.dumps(dict(conf, name=NAME)))
    shutil.copy(data / "cells" / f"{LIKE}.json",
                data / "cells" / f"{CELL}.json")
    shutil.copy(sized / "configs" / "yi-9b.json",
                sized / "configs" / f"{NAME}.json")
    bench["configs"].append(dict(entry, name=NAME,
                                 file=f"bench/configs/{NAME}.json"))
    bench["workloads"].append({"name": CELL, "config": NAME,
                               "traffic": "long_prompt", "chips": 1,
                               "why": "the copy's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    for mod in (spec, metrics):        # the readers are found by it too
        monkeypatch.setattr(mod, "BENCH", data)
    run = tmp_path / "run"
    run.mkdir()
    return run, bench, root, sized


@pytest.mark.parametrize("trace", [False, True])
def test_a_second_configuration_runs_correct_at_smoke_size(second, trace):
    run, bench, root, sized = second
    root, bench = bench_smoke.setup(run, bench=bench, root=root, sized=sized)
    assert json.loads((run / f"{NAME}.json").read_text())[
        "num_hidden_layers"] == 2
    res, lines = bench_run.execute(
        CELL, 2 ** 31 + 3, 1.5, trace, "cpu", root=root, bench=bench,
        overlay=bench_smoke.overlay(CELL, bench, sized))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in bench[kind]
              if m["source"] != "device_trace"
              and ("workloads" not in m or CELL in m["workloads"])}
    assert set(res["metrics"]) == listed
    assert lines[0].startswith("compared widest_gap ")


def test_the_control_test_takes_a_second_configuration(second, monkeypatch):
    run, bench, root, sized = second
    rows = bench_smoke.control_readings(run, CELL, monkeypatch, seeds=[1],
                                        size="smoke", bench=bench,
                                        root=root, sized=sized)
    assert len(rows) == 1
    r = rows[0]
    assert r["failed"] == 0 and r["tokens"] > 0, r
    # one seed at smoke size: this checks that the control is run and read
    # for the copy's cell, not that it fails (``control_case`` asks that)
    assert r["program_gap"] <= r["limit"], r
    assert math.isfinite(r["control_gap"]), r
