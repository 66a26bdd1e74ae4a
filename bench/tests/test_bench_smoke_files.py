"""Each name of ``BENCHMARK.json`` has the files that the CPU tests find by
it, so that a cell a later change adds enters them by new files alone: a
sized file for each configuration (``bench/tests/smoke/configs/``), smoke
traffic for each mix a cell serves (``bench/tests/smoke/traffic/``), one
control test file for each cell and none for a cell that is absent, and a
plain reference module that exposes what the harness calls."""
from __future__ import annotations

import importlib
import inspect
import json

import pytest

import bench_smoke
from bench.harness import program

ROOT = bench_smoke.ROOT
TESTS = ROOT / "bench" / "tests"
B = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in B["workloads"]]
MIXES = sorted({w["traffic"] for w in B["workloads"]})
#: what ``bench/run.py``, ``bench/harness/check.py`` and the ``mfu`` readers
#: call on a configuration's reference module
CALLED = ("layout", "logits", "mm_fp8", "ieee_f32", "prefill_flops",
          "decode_flops")


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_a_sized_file(c):
    blocks = bench_smoke.sizes(c["name"])
    keys = set(json.loads((ROOT / c["file"]).read_text()))
    path = bench_smoke.SIZED / "configs" / f"{c['name']}.json"
    for size in bench_smoke.SIZES:
        assert size in blocks, f"{path}: add the block {size!r}"
        block = blocks[size]
        assert set(block) == {"config", "port_fields"}, (path, size)
        assert set(block["config"]) <= keys, (path, size)
        program.model_config(bench_smoke.config(c["name"], size))


@pytest.mark.parametrize("mix", MIXES)
def test_every_mix_a_cell_serves_has_smoke_traffic(mix):
    cell = next(w["name"] for w in B["workloads"] if w["traffic"] == mix)
    got = bench_smoke.overlay(cell)
    keys = set(json.loads((ROOT / "bench/traffic" / f"{mix}.json")
                          .read_text()))
    for w in B["workloads"]:
        own = ROOT / "bench/cells" / f"{w['name']}.json"
        if w["traffic"] == mix and own.exists():
            keys |= set(json.loads(own.read_text()))
    assert set(got) <= keys, (mix, set(got) - keys)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_control_file(cell):
    path = TESTS / bench_smoke.control_file(cell)
    assert path.exists(), \
        f"{path}: add it, calling bench_smoke.control_case(tmp_path, " \
        "__file__, monkeypatch)"


def test_no_control_file_names_an_absent_cell():
    want = {bench_smoke.control_file(c) for c in CELLS}
    for path in sorted(TESTS.glob("test_bench_control_*.py")):
        assert path.name in want, \
            f"{path}: names no cell of BENCHMARK.json ({sorted(want)})"


@pytest.mark.parametrize("ref", sorted({
    json.loads((ROOT / c["file"]).read_text())["reference"]
    for c in B["configs"]}))
def test_reference_exposes_what_the_harness_calls(ref):
    mod = importlib.import_module(f"bench.reference.{ref}")
    for name in CALLED:
        assert callable(getattr(mod, name, None)), \
            f"bench/reference/{ref}.py: define {name}"
    params = inspect.signature(mod.logits).parameters
    positional = [p for p in params.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    assert len(positional) >= 4 and "mm" in params, \
        f"bench/reference/{ref}.py: logits(w, c, seq, start, mm=...)"
