"""Spans with device intervals (``Tracer.span(device=...)``), on the CPU:

* the spans a traced ``Server`` run records (``server.tick`` holding
  ``server.prefill`` and ``server.decode``, each holding one
  ``model.forward``, each holding a ``model.attn`` and a ``model.mlp`` a
  layer), their attributes, and their device intervals, which on the CPU
  are their host intervals; greedy tokens equal with tracing on and off;
* the attention, MoE and decoder blocks' halves in a prefill and a decode
  forward, and no ``model.*`` span in a train step;
* a disabled tracer: no span, no object, no ``torch.cuda.Event``;
* the CUDA path's arithmetic (anchor, lazy reads, capture) on a faked
  card; the exporters write the host interval alone, as the reference's.

The card itself: ``tests/test_torch_gpu.py -k device_interval``.
"""
import json

import pytest
import torch

import repro.obs as jobs
from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.model import lm as tlm
from repro_torch.model import transformer as ttf
from repro_torch.obs import trace as ttrace
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.server import Server, ServerConfig

PROMPTS = [[3, 9, 4, 7, 11, 2], [5, 8, 13, 6, 2, 9, 10, 4, 7, 3, 12], [6, 4]]
NEW = 4
SLOTS = 2
MODEL_SPANS = ("model.forward", "model.attn", "model.mlp")


def _par(scan):
    return ParallelismConfig(compute_dtype="float32", scan_layers=scan)


def _params(cfg, scan, kind="prefill"):
    return tlm.Stepper(cfg, ShapeConfig("s", kind, 16, 1), SMOKE_MESH,
                       _par(scan)).init(seed=3, device="cpu")


def _serve(cfg, params, scan):
    srv = Server(cfg, params, ServerConfig(batch_slots=SLOTS, max_len=24,
                                           eos_token=-1), SMOKE_MESH,
                 _par(scan), device="cpu")
    for p in PROMPTS:
        srv.submit(p, max_new_tokens=NEW)
    return [r.out_tokens for r in srv.run_until_drained()]


@pytest.fixture(scope="module", params=["yi-9b", "deepseek-moe-16b"])
def served(request):
    """A smoke server's greedy tokens untraced, and traced with the spans
    it recorded (a dense model, and an MoE one whose first layer is
    dense)."""
    cfg = get_config(request.param, smoke=True)
    params = _params(cfg, False)
    plain = _serve(cfg, params, False)
    with tobs.capture("serve") as cap:
        traced = _serve(cfg, params, False)
    return cfg, plain, traced, cap.trace.spans


def _kids(spans, parent, name=None):
    return [s for s in tobs.children_of(spans, parent)
            if name is None or s.name == name]


def test_server_span_tree_on_the_cpu(served):
    cfg, _, _, spans = served
    L = cfg.n_layers
    ticks = tobs.find_spans(spans, "server.tick")
    assert ticks and all(s.parent_id is None for s in ticks)
    prefills, decodes = [], []
    for t in ticks:
        assert {k.name for k in _kids(spans, t)} <= {"server.prefill",
                                                     "server.decode"}
        prefills += _kids(spans, t, "server.prefill")
        decodes += _kids(spans, t, "server.decode")
    assert [s.attrs["prompt_len"] for s in prefills] == [len(p)
                                                         for p in PROMPTS]
    assert len(decodes) == len(ticks)
    forwards = []
    for outer, mode in [(s, "prefill") for s in prefills] + [
            (s, "decode") for s in decodes]:
        (fwd,) = _kids(spans, outer)
        assert fwd.name == "model.forward" and fwd.attrs["mode"] == mode
        if mode == "prefill":
            assert fwd.attrs["rows"] == 1
            assert fwd.attrs["tokens"] == outer.attrs["prompt_len"]
        else:
            assert fwd.attrs["rows"] == fwd.attrs["tokens"] == SLOTS
        halves = _kids(spans, fwd)
        assert [(s.name, s.attrs) for s in halves] == [
            (name, {"layer": l}) for l in range(L)
            for name in ("model.attn", "model.mlp")]
        forwards += [fwd, *halves]
    assert len(forwards) == len([s for s in spans if s.name in MODEL_SPANS])
    # the CPU runs the work as it is enqueued: the device interval is the
    # host interval wherever the span was opened with ``device=``
    for s in prefills + forwards:
        assert (s.dev_start, s.dev_end) == (s.start, s.end)
    for s in ticks + decodes:
        assert s.dev_start is None and s.dev_end is None


def test_greedy_tokens_are_equal_with_tracing_on_and_off(served):
    _, plain, traced, _ = served
    assert traced == plain and all(len(t) == NEW for t in traced)


def test_a_disabled_tracer_records_nothing_and_builds_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a disabled tracer built a torch.cuda.Event")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(ttrace.Tracer, "_mark", refuse)
    off = tobs.Tracer(enabled=False)
    assert off.span("model.attn", device="cuda:0", layer=0) is \
        ttrace._NULL_SPAN
    prev = tobs.set_tracer(off)
    try:
        cfg = get_config("yi-9b", smoke=True)
        tokens = _serve(cfg, _params(cfg, False), False)
    finally:
        tobs.set_tracer(prev)
    assert off.spans == [] and off._next_id == 1 and off._anchors == {}
    assert all(len(t) == NEW for t in tokens)


def _batch(cfg, S, B=1):
    specs = tlm.input_specs(cfg, ShapeConfig("p", "prefill", S, B))
    g = torch.Generator().manual_seed(1)
    out = {}
    for k, (shape, _) in specs.items():
        out[k] = (torch.randint(2, cfg.vocab_size, shape, generator=g)
                  if k == "tokens" else torch.randn(shape, generator=g))
    return out


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b",
                                  "whisper-tiny"])
def test_block_halves_in_prefill_and_decode(arch):
    """Each attention, MoE or decoder layer records one ``model.attn`` and
    one ``model.mlp`` in a prefill and in a decode forward (an encoder
    layer none), in layer order; the forward's numbers are unchanged."""
    cfg = get_config(arch, smoke=True)
    params = _params(cfg, False)
    kinds = [k for k, n in ttf.group_structure(cfg) for _ in range(n)]
    layers = [l for l, k in enumerate(kinds) if k != "enc"]
    batch = _batch(cfg, 6)
    prefill = tlm.make_prefill_step(cfg, SMOKE_MESH, _par(False))
    decode = tlm.make_decode_step(cfg, SMOKE_MESH, _par(False))
    nxt = torch.tensor([[5]])
    with torch.no_grad():
        want, cache = prefill(params, batch)
        want_dec, _ = decode(params, nxt, ttf.pad_cache(cache, 10))
        with tobs.capture("fwd") as cap:
            got, cache = prefill(params, batch)
            got_dec, _ = decode(params, nxt, ttf.pad_cache(cache, 10))
    assert torch.equal(got, want) and torch.equal(got_dec, want_dec)
    spans = cap.trace.spans
    assert all(s.parent_id is None for s in spans)
    order = [(s.name, s.attrs["layer"]) for s in sorted(spans,
                                                        key=lambda s: s.start)]
    one = [(n, l) for l in layers for n in ("model.attn", "model.mlp")]
    assert order == one + one


def test_a_train_step_records_no_model_span():
    cfg = get_config("yi-9b", smoke=True)
    st = tlm.Stepper(cfg, ShapeConfig("t", "train", 8, 2), SMOKE_MESH,
                     _par(False))
    params = st.init(seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(2, cfg.vocab_size, (2, 8), generator=g)
             for k in ("tokens", "targets")}
    with tobs.capture("train") as cap:
        st.train_fn()(params, tadamw.init_opt_state(params), batch)
        with torch.no_grad():
            st.prefill_fn()(params, {"tokens": batch["tokens"][:1]})
    names = [s.name for s in cap.trace.spans]
    # the prefill after it records its halves: the capture was live
    assert names == ["model.attn", "model.mlp"] * cfg.n_layers


# --------------------------------------------------------------------------- #
# The CUDA path on a faked card
# --------------------------------------------------------------------------- #


class _Card:
    """A card's clock (``now``), how far its stream has run (``reached``),
    and whether it is capturing; its events stamp ``now`` when recorded."""

    def __init__(self):
        self.now, self.reached, self.capturing = 100.0, 1e9, False
        self.syncs = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None

            def record(self, stream=None):
                self.t = card.now

            def query(self):
                return self.t <= card.reached

            def synchronize(self):
                assert self.query()

            def elapsed_time(self, end):
                return (end.t - self.t) * 1e3

        self.Event = Event

    def install(self, monkeypatch):
        for name, fn in dict(
                Event=self.Event, current_device=lambda: 0,
                current_stream=lambda index=None: None,
                is_current_stream_capturing=lambda: self.capturing,
                synchronize=lambda index=None: setattr(
                    self, "syncs", self.syncs + 1)).items():
            monkeypatch.setattr(torch.cuda, name, fn)


def test_device_times_on_a_faked_card(monkeypatch):
    """The first timed span anchors the card (one synchronize), later ones
    do not; each event lands at the anchor's host reading plus its time
    after the anchor's event; a span whose end the card has not reached
    keeps no device times until it has; a span opened while the stream is
    captured records none; a span without ``device`` none either."""
    card = _Card()
    card.install(monkeypatch)
    host = iter(float(t) for t in range(10, 100))
    trc = tobs.Tracer(clock=lambda: next(host))
    with trc.span("a", device=torch.device("cuda")):  # host 10 (11), 14
        card.now = 100.5                 # the anchor: host 11 at card 100
        with trc.span("b", device="cuda:0", layer=3):  # host 12, 13
            card.now = 101.25
        card.now = 102.0
    assert card.syncs == 1
    assert [(s.dev_start, s.dev_end) for s in trc.spans] == [
        (11.5, 12.25), (11.0, 13.0)]
    card.reached = card.now
    with trc.span("late", device="cuda"):
        card.now = 103.0
    with trc.span("host_only"):
        pass
    card.capturing = True
    with trc.span("captured", device="cuda"):
        pass
    (late,) = tobs.find_spans(trc.spans, "late")
    assert late.dev_start is None and len(trc._pending) == 1
    card.reached = card.now
    assert trc.spans[2] is late
    assert (late.dev_start, late.dev_end) == (13.0, 14.0)
    assert not trc._pending and card.syncs == 1
    for name in ("host_only", "captured"):
        (s,) = tobs.find_spans(trc.spans, name)
        assert s.dev_start is None and s.dev_end is None
    assert [s.name for s in trc.spans] == ["b", "a", "late", "host_only",
                                           "captured"]


# --------------------------------------------------------------------------- #
# Exporters
# --------------------------------------------------------------------------- #


def _record(obs, **kw):
    clock = iter(0.25 * t for t in range(40))
    trc = obs.Tracer(clock=lambda: next(clock))
    with trc.span("outer", n=2, **kw):
        with trc.span("inner", mode="decode", **kw):
            pass
    return trc.spans


@pytest.mark.parametrize("kw", [{}, {"device": "cpu"}],
                         ids=["host", "device"])
def test_spans_export_as_the_reference(kw):
    """The exporters write the host interval alone: a span opened with
    ``device=`` exports as one opened without, as the reference's."""
    got, want = _record(tobs, **kw), _record(jobs)
    assert tobs.to_jsonl(got) == jobs.to_jsonl(want)
    assert json.dumps(tobs.to_chrome_trace(got)) == json.dumps(
        jobs.to_chrome_trace(want))
