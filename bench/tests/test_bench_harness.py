"""The harness end to end on the CPU at the smoke size: each cell of
``BENCHMARK.json`` runs, serves, reads its metrics and judges its sample
against the plain reference; a broken timed path comes out not correct."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import bench_smoke
from bench import run as bench_run

CELLS = [w["name"] for w in json.loads(
    (bench_smoke.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _execute(tmp_path, cell, trace=False, server_cls=None, seed=2 ** 31 + 3,
             seconds=1.5):
    root, bench = bench_smoke.setup(tmp_path)
    return bench_run.execute(cell, seed, seconds, trace, "cpu", root=root,
                             bench=bench, server_cls=server_cls,
                             overlay=bench_smoke.overlay(cell))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_cpu(tmp_path, cell, trace):
    res, lines = _execute(tmp_path, cell, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    bench = json.loads((bench_smoke.ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in bench[kind]
              if "workloads" not in m or cell in m["workloads"]}
    got = set(res["metrics"])
    # a CPU run has no device trace: its readers find nothing to read
    device = {m["name"] for m in bench[kind] if m["source"] == "device_trace"}
    assert got == listed - device
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "compared"
    assert lines[0].startswith("compared widest_gap ")


def test_the_same_seed_draws_the_same_inputs():
    from bench.harness import weights as wts
    from bench.reference import dense

    conf = bench_smoke.config()
    a = wts.draw(dense.layout(conf), 2 ** 31 + 9, torch.bfloat16, "cpu")
    b = wts.draw(dense.layout(conf), 2 ** 31 + 9, torch.bfloat16, "cpu")
    c = wts.draw(dense.layout(conf), 2 ** 31 + 10, torch.bfloat16, "cpu")
    assert torch.equal(a["g0"]["attn"]["wq"], b["g0"]["attn"]["wq"])
    assert not torch.equal(a["g0"]["attn"]["wq"], c["g0"]["attn"]["wq"])


def _faulty(kind):
    from repro_torch.runtime.server import Server

    class Faulty(Server):
        """``Server`` with the timed path broken: ``token`` alters each
        busy row's token where it is sampled every third tick (to the
        row's least likely one), ``state``
        decodes on a copy of the cache and keeps the old one (a step that
        returns its state unchanged)."""

        ticks = 0

        def _sample(self, logits):
            tok = super()._sample(logits)
            busy = [i for i, r in enumerate(self._slots) if r is not None]
            if kind == "token" and logits.shape[0] > 1 and busy:
                Faulty.ticks += 1
                if Faulty.ticks % 3 == 0:
                    tok = tok.copy()
                    tok[busy] = np.argmin(logits[busy], axis=-1)
            return tok

        def step(self):
            if kind == "state" and self._cache is not None:
                keep = self._cache
                decode = self._decode

                def unchanged(params, tokens, cache):
                    from repro_torch.model.layers import tree_map
                    copy = tree_map(torch.clone, cache)
                    logits, _ = decode(params, tokens, copy)
                    return logits, keep

                self._decode = unchanged
                try:
                    super().step()
                finally:
                    self._decode = decode
            else:
                super().step()

    return Faulty


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault,
                                           monkeypatch):
    # a fault shows from a request's third token on: a window of 40 ticks
    # on a virtual clock, however loaded the host
    res, _ = _execute(tmp_path, cell, seconds=4.0, server_cls=bench_smoke.
                      virtual_time(monkeypatch, _faulty(fault)))
    assert res["correct"] is False
    assert res["compared"]["widest_gap"]["value"] > \
        res["compared"]["widest_gap"]["limit"]
