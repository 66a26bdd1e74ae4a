"""The benchmark's arithmetic against hand counts: percentiles, time to
first token (a stalled window included), gaps between tokens, tokens per
second, the model's FLOPs, B5's FLOPs and bytes, and the device
trace's busy time and idle gaps."""
from __future__ import annotations

import pytest

import bench_smoke  # noqa: F401  (puts the repository on the path)
from bench.harness import counts, devtrace, stats
from bench.reference import dense


def test_percentile_interpolates_between_order_statistics():
    assert stats.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.5
    assert stats.percentile(list(range(11)), 90) == 9.0
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_ttft_counts_only_due_requests_and_a_stall_at_the_end():
    dues = [0.5, 1.0, 2.0, 9.0, 12.0]
    firsts = [0.75, None, 11.0, 9.5, None]   # 1.0 never, 2.0 after the end
    got = stats.ttfts(dues, firsts, 0.0, 10.0)
    assert got == pytest.approx([0.25, 9.0, 8.0, 0.5])


def test_gaps_take_both_tokens_inside_the_window():
    stamps = [[0.5, 1.5, 2.0, 11.0], [3.0], [9.0, 9.25]]
    assert stats.gaps(stamps, 1.0, 10.0) == pytest.approx([0.5, 0.25])
    assert stats.tokens_in(stamps, 1.0, 10.0) == 5


YI = dict(num_hidden_layers=48, hidden_size=4096, num_attention_heads=32,
          num_key_value_heads=4, head_dim=128, intermediate_size=11008,
          vocab_size=64000)


def test_model_flops_by_hand():
    # one layer's products: q 4096x4096, k and v 4096x512, o 4096x4096,
    # gate/up/down 3 x 4096x11008
    per_layer = 4096 * 4096 * 2 + 4096 * 512 * 2 + 3 * 4096 * 11008
    assert dense._matmul_params(YI) == per_layer
    n = 2048
    attn = 4 * 128 * 32 * n * (n + 1) // 2
    head = 2 * 4096 * 64000
    assert dense.prefill_flops(YI, n) == 48 * (2 * per_layer * n + attn) + head
    assert dense.decode_flops(YI, 100) == \
        48 * (2 * per_layer + 4 * 128 * 32 * 100) + head


def test_b5_counts_by_hand():
    # 3 queries: 6 causal pairs, 4 hd flops each per head
    assert counts.b5_flops(3, heads=2, hd=8) == 6 * 4 * 8 * 2
    # q and o (2 heads) and k and v (1 kv head), 3 rows of 8, bf16
    assert counts.b5_bytes(3, 2, 1, 8) == 2 * 3 * 8 * (2 * 2 + 2 * 1)
    flops, nbytes = 989e12, 3.35e12 * 2
    assert counts.bound_s(flops, nbytes) == pytest.approx(2.0)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_device_trace_union_and_named_gaps():
    doc = {"traceEvents": [
        _ev(devtrace.SLICE, "user_annotation", 0.0, 100.0),
        _ev("server.decode", "user_annotation", 0.0, 100.0),
        _ev("aten::mm", "cpu_op", 5.0, 20.0),
        _ev("k1", "kernel", 10.0, 20.0),      # 10-30
        _ev("k2", "kernel", 20.0, 20.0),      # overlaps: union 10-40
        _ev("k1", "kernel", 60.0, 10.0),      # 60-70
        _ev("late", "kernel", 95.0, 20.0),    # clipped to 95-100
    ]}
    t = devtrace.reduce(doc)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.by_kernel["k1"] == pytest.approx(30e-6)
    assert t.seconds_of("k1") == (pytest.approx(30e-6), 2)
    # gaps 0-10 (aten::mm), 40-60, 70-95 (no operator): 55 us idle
    assert sum(t.idle_by_host.values()) == pytest.approx(55e-6)
    assert t.idle_by_host["server.decode/aten::mm"] == pytest.approx(10e-6)
    assert t.idle_by_host["server.decode"] == pytest.approx(45e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2
