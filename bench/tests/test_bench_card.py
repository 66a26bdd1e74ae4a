"""Each cell of ``BENCHMARK.json`` on the card, for a short window: the
run is correct, reports every end-to-end metric, and its traced run every
per-layer metric the cell lists. Skips without a CUDA card.

    python -m pytest -q -m gpu bench/tests/test_bench_card.py
"""
from __future__ import annotations

import json

import pytest

import bench_smoke
from bench import run as bench_run

BENCH = json.loads((bench_smoke.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell, trace):
    res, _ = bench_run.execute(cell, 2 ** 31 + 77, 12.0, trace, card)
    assert res["correct"] is True, res["compared"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"
