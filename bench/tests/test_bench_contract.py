"""``BENCHMARK.json`` keeps to the form the benchmark's runner and its
checker read: the keys of each entry, names and units of the allowed
characters, bounds within (0.01, 0.25], every cell reporting ``setup_s``,
another end-to-end metric and a per-layer metric, each per-layer metric
moving an end-to-end metric its cells report, and a file for every name
the harness looks up (configuration, mix, reader)."""
from __future__ import annotations

import json
import re

import pytest

import bench_smoke

ROOT = bench_smoke.ROOT
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _reports(cell, kind):
    return {m["name"] for m in B[kind]
            if "workloads" not in m or cell in m["workloads"]}


def test_top_level_and_entry_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and B["paths"] == ["bench"]
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").exists()
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units_and_readers(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (ROOT / "bench/metrics" / f"{m['name']}.py").exists()
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e, layer = _reports(cell, "end_to_end"), _reports(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in B["per_layer"]:
        if m["name"] in layer:
            assert m["moves"] in e2e, (m["name"], cell)
