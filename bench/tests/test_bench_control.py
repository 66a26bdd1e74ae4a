"""The control comes out not correct: the reference computed with float8
products put in the program's place reads a widest gap over each cell's
limit, where the program's own runs read under it. At a size a CPU test
holds: the Yi-9B file at its 48 layers but width 128 (depth is what
carries float8's rounding into the logits), each mix's smoke traffic
served on a virtual clock (the same tokens however loaded the host) and
judged over up to 320 served tokens. At this size a control can read
under the limit (0.19 of 0.25 once in eight seeds, on the host clock);
on the card at the cells' own size every control read at least 1.8
times the limit (PERF.md, ``bench/control.py``). So the test asks it of
most seeds."""
from __future__ import annotations

import json

import pytest

import bench_smoke
from bench import control

MID = dict(num_hidden_layers=48, hidden_size=128, num_attention_heads=4,
           num_key_value_heads=1, head_dim=32, intermediate_size=256,
           vocab_size=2048)
PORT_MID = dict(n_layers=48, d_model=128, n_heads=4, n_kv_heads=1,
                head_dim=32, d_ff=256, vocab_size=2048)
CELLS = [w["name"] for w in json.loads(
    (bench_smoke.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_that_the_program_keeps(tmp_path, cell,
                                                       monkeypatch):
    conf = bench_smoke.config()
    conf.update(MID)
    conf["port"]["fields"].update(PORT_MID)
    root, bench = bench_smoke.setup(tmp_path)
    (tmp_path / "c.json").write_text(json.dumps(conf))
    ov = dict(bench_smoke.overlay(cell), check_tokens=320)
    # on a virtual clock: the same tokens served however loaded the host
    # (the control's misses are read at served positions only)
    rows = list(control.readings(
        cell, [1, 2, 3, 4, 5], 3.0, "cpu", root=root, bench=bench,
        overlay=ov, server_cls=bench_smoke.virtual_time(monkeypatch)))
    for r in rows:
        assert r["failed"] == 0 and r["tokens"] >= 100, r
        assert r["program_gap"] <= r["limit"], r
    assert sum(r["control_gap"] > r["limit"] for r in rows) >= 3, rows
