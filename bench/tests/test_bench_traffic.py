"""The traffic generator: every seed draws the same schedule (lengths and
arrivals, the quantiles of the mix's distributions in the mix's own order)
with its own token ids; an open loop's arrivals fill the window; a closed
loop's rounds each hold the same lengths."""
from __future__ import annotations

import json

import numpy as np

import bench_smoke
from bench.harness import traffic

MIXES = {p.stem: json.loads(p.read_text())
         for p in (bench_smoke.ROOT / "bench" / "traffic").glob("*.json")}
CELLS = {p.stem: json.loads(p.read_text())
         for p in (bench_smoke.ROOT / "bench" / "cells").glob("*.json")}


def _mix(name):
    mix = dict(MIXES[name])
    mix.setdefault("rate_per_s", 1.5)
    return mix


def test_every_seed_draws_the_same_schedule_with_its_own_tokens():
    for name in MIXES:
        mix = _mix(name)
        a = traffic.generate(mix, 2 ** 31 + 11, 30, 64000)
        b = traffic.generate(mix, 5, 30, 64000)
        assert [(len(r.prompt), r.out_len, r.due, r.client) for r in a] == \
            [(len(r.prompt), r.out_len, r.due, r.client) for r in b]
        assert [r.prompt for r in a] != [r.prompt for r in b]
        assert a and all(len(r.prompt) + r.out_len <= mix["max_len"]
                         for r in a)
        other = traffic.generate(dict(mix, schedule_seed=1), 5, 30, 64000)
        assert sorted(len(r.prompt) - r.head for r in other) == \
            sorted(len(r.prompt) - r.head for r in b)
        assert [len(r.prompt) for r in other] != [len(r.prompt) for r in b]


def test_lengths_keep_to_their_distributions():
    lp = traffic.quantiles(MIXES["long_prompt"]["prompt"], 1001)
    assert lp.min() >= 512 and lp.max() <= 4000 and np.median(lp) == 2048
    out = traffic.quantiles(MIXES["long_decode"]["output"], 1000)
    assert out.min() == 512 and out.max() == 2048


def test_open_loop_arrivals_fill_the_window():
    mix = _mix("long_prompt")
    reqs = traffic.generate(mix, 3, 40, 64000)
    assert len(reqs) == round(1.5 * 40)
    assert 0 < reqs[0].due and 35 < reqs[-1].due < 42


def test_closed_loop_rounds_hold_the_same_lengths():
    mix = MIXES["long_decode"]
    reqs = traffic.generate(mix, 9, 30, 64000)
    n = mix["clients"]
    first = sorted(len(r.prompt) - r.head for r in reqs[:n])
    second = sorted(len(r.prompt) for r in reqs[n:2 * n])
    assert first == second and [r.client for r in reqs[:n]] == list(range(n))
    assert all(r.head == 0 for r in reqs[n:])


def test_closed_loop_opens_part_way_as_a_steady_pool():
    mix = MIXES["long_decode"]
    reqs = traffic.generate(mix, 9, 30, 64000)
    n = mix["clients"]
    first, later = reqs[:n], reqs[n:2 * n]
    # each first request part-way through its reply, at least one token
    # still to come, the shares spread over the whole reply
    assert all(0 <= r.head and r.out_len >= 1 for r in first)
    share = sorted(r.head / (r.head + r.out_len) for r in first)
    assert share[0] < 0.1 and share[-1] > 0.9
    # drawn in proportion to their length: longer than a fresh round
    assert np.mean([r.head + r.out_len for r in first]) > \
        np.mean([r.out_len for r in later]) + 100
    assert max(len(r.prompt) for r in first) > 1500
    # some replies finish within a window of ~90 ticks
    assert sum(r.out_len < 90 for r in first) >= 2
    assert all(len(r.prompt) + r.out_len <= mix["max_len"] for r in reqs)


def test_length_biased_quantiles_weigh_by_length():
    dist = {"dist": "uniform", "min": 512, "max": 2048}
    b = traffic.length_biased(dist, 1000)
    assert b.min() >= 512 and b.max() <= 2048
    # uniform(a, b) weighted by x has mean (a^2 + ab + b^2) / (1.5 (a + b))
    want = (512 ** 2 + 512 * 2048 + 2048 ** 2) / (1.5 * (512 + 2048))
    assert abs(b.mean() - want) < 5


def test_cell_files_name_cells_of_the_benchmark():
    bench = json.loads((bench_smoke.ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    assert set(CELLS) <= names
