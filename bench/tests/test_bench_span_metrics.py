"""The readers of the program's model spans against hand counts, on a span
list built by hand: ``decode_attn_ms``, ``decode_mlp_ms``,
``decode_launch_ms`` and ``mfu.prefill_forward``. The list holds spans
that end before and after the window, and a prefill's halves beside the
decode ticks' (a tick holds both); a run whose program records no
``model.forward`` (the parent's) gives no reading."""
from __future__ import annotations

import pytest

import bench_smoke
from bench.harness import metrics
from bench.harness.counts import BF16_FLOP_PER_S
from bench.harness.serve import Run
from bench.reference import dense
from repro_torch.obs import Span

T0, T1 = 10.0, 20.0


def _span(sid, name, host, parent=None, dev=None, **attrs):
    s = Span(name=name, start=host[0], end=host[1], attrs=attrs, span_id=sid,
             parent_id=parent)
    if dev is not None:
        s.dev_start, s.dev_end = dev
    return s


def _forward(sid, parent, host, dev, mode, rows, tokens, halves):
    """A ``model.forward`` and its halves: ``halves`` is a list of
    (attention, MLP) device seconds, one a layer, laid end to end from the
    forward's device start."""
    out = [_span(sid, "model.forward", host, parent, dev, mode=mode,
                 rows=rows, tokens=tokens)]
    t = dev[0]
    for layer, (a, m) in enumerate(halves):
        out.append(_span(sid + 1 + 2 * layer, "model.attn", host, sid,
                         (t, t + a), layer=layer))
        out.append(_span(sid + 2 + 2 * layer, "model.mlp", host, sid,
                         (t + a, t + a + m), layer=layer))
        t += a + m
    return out


def _spans():
    return [
        # a tick before the window: its decode counts nowhere
        _span(1, "server.tick", (9.0, 9.6)),
        _span(2, "server.decode", (9.0, 9.6), 1),
        *_forward(3, 2, (9.0, 9.5), (9.0, 9.55), "decode", 4, 4,
                  [(0.25, 0.25), (0.25, 0.25)]),
        # a tick holding a prefill and a decode
        _span(10, "server.tick", (11.0, 11.6)),
        _span(11, "server.prefill", (11.0, 11.25), 10, (11.0, 11.22),
              rid=0, prompt_len=32),
        *_forward(12, 11, (11.0, 11.02), (11.01, 11.21), "prefill", 1, 32,
                  [(0.0625, 0.03), (0.0625, 0.04)]),
        _span(20, "server.decode", (11.25, 11.6), 10),
        *_forward(21, 20, (11.25, 11.254), (11.26, 11.56), "decode", 4, 4,
                  [(0.125, 0.0125), (0.125, 0.0125)]),
        # a tick of a decode alone
        _span(30, "server.tick", (12.0, 12.3)),
        _span(31, "server.decode", (12.0, 12.3), 30),
        *_forward(32, 31, (12.0, 12.006), (12.01, 12.25), "decode", 4, 4,
                  [(0.0625, 0.0125), (0.0625, 0.025)]),
        # a prefill that ends after the window
        _span(40, "server.tick", (19.9, 20.5)),
        _span(41, "server.prefill", (19.9, 20.5), 40, (19.9, 20.4),
              rid=1, prompt_len=64),
        *_forward(42, 41, (19.9, 20.1), (19.95, 20.4), "prefill", 1, 64,
                  [(0.125, 0.125), (0.125, 0.125)]),
    ]


def _reading(spans):
    run = Run(t0=T0, t1=T1, setup_s=1.0, served=[], spans=spans)
    return metrics.Reading(run=run, config=bench_smoke.config(), model=dense)


@pytest.mark.parametrize("name,want", [
    ("decode_attn_ms", 1e3 * (0.25 + 0.125) / 2),
    ("decode_mlp_ms", 1e3 * (0.025 + 0.0375) / 2),
    ("decode_launch_ms", 1e3 * (0.004 + 0.006) / 2),
    ("mfu.prefill_forward",
     100.0 * dense.prefill_flops(bench_smoke.config(), 32)
     / (0.2 * BF16_FLOP_PER_S)),
])
def test_reader_gives_its_value_by_hand(name, want):
    assert metrics.reader(name).read(_reading(_spans())) == \
        pytest.approx(want, rel=1e-9)


def test_mfu_prefill_forward_counts_each_row():
    """A forward of two rows of 16 tokens is twice the work of one."""
    spans = _forward(1, None, (11.0, 11.1), (11.0, 11.5), "prefill", 2, 32,
                     [(0.25, 0.25)])
    want = 100.0 * 2 * dense.prefill_flops(bench_smoke.config(), 16) / (
        0.5 * BF16_FLOP_PER_S)
    assert metrics.reader("mfu.prefill_forward").read(_reading(spans)) == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["decode_attn_ms", "decode_mlp_ms",
                                  "decode_launch_ms", "mfu.prefill_forward"])
def test_reader_finds_nothing_without_model_spans(name):
    """The server's spans alone, as a program without ``model.forward``
    records them, and spans opened without a device interval."""
    spans = [s for s in _spans() if not s.name.startswith("model.")]
    for s in spans:
        s.dev_start = s.dev_end = None
    assert metrics.reader(name).read(_reading(spans)) is None
