"""The decode-attention kernel's wrapper on the CPU (``kernels/
decode_attention``): its plain version against the ``attn_impl="ref"``
path at Sq = 1, ragged lengths, the wrapper's checks, the split plan, and
the ``attn_impl="flash"`` decode route through ``attn_apply`` and
``Server``. The kernels themselves run on the card
(``tests/test_torch_gpu.py -k decode_attention``).

Imports nothing of JAX. Tolerances: f32 1e-5 absolute (the two paths sum
the same products in other orders); bf16 one rounding of the output (the
outputs are bf16 of magnitude under 2, whose spacing there is 2^-7).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.model import attention as tattn
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model.layers import tree_map
from repro_torch.model.transformer import pad_cache
from repro_torch.runtime.server import Server, ServerConfig

TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _case(G, hd, dtype, B=3, KV=2, S=11, seed=0):
    gen = torch.Generator().manual_seed(seed + 97 * G + hd)
    q = torch.randn((B, 1, KV * G, hd), generator=gen).to(dtype)
    k, v = (torch.randn((B, S, KV, hd), generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v


def _ref_path(q, k, v, kv_len):
    """``attn_impl="ref"``'s decode: K/V repeated to every q head, then
    ``attention_core`` under the ``kv_len`` mask, not causal."""
    ctx = tlayers.Ctx(get_config("yi-9b", smoke=True), SMOKE_MESH, "decode",
                      attn_impl="ref")
    G = q.shape[2] // k.shape[2]
    return tattn.attention_core(q, tattn._repeat_kv(k, G),
                                tattn._repeat_kv(v, G), ctx, causal=False,
                                kv_len=kv_len)


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 112, 128, 160])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
def test_plain_version_matches_the_ref_path(G, hd, dtype):
    q, k, v = _case(G, hd, dtype)
    kv_len = torch.tensor([11, 4, 7], dtype=torch.int32)
    before = dec_ops.launches
    got = decode_attention(q, k, v, kv_len)
    assert dec_ops.launches == before          # the CPU runs no kernel
    _close(got, _ref_path(q, k, v, kv_len), dtype)
    _close(decode_attention_ref(q, k, v, kv_len), got, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [(1, 1, 1), (11, 11, 11), (1, 11, 16),
                                  (6, 1, 2)])
def test_ragged_lengths_and_free_slots(lens, dtype):
    """Lengths of 1, of S_max, and S_max + 5 (a free slot whose position
    keeps counting: all S_max keys); keys past a row's length never
    matter."""
    q, k, v = _case(4, 64, dtype, S=11)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    got = decode_attention(q, k, v, kv_len)
    _close(got, _ref_path(q, k, v, kv_len), dtype)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lens):
        k2[b, n:] = 300.0
        v2[b, n:] = -1e4
    assert torch.equal(decode_attention(q, k2, v2, kv_len), got)
    # int64 lengths give the same
    assert torch.equal(decode_attention(q, k, v, kv_len.long()), got)


def test_one_key_returns_its_value():
    q, k, v = _case(2, 16, torch.float32)
    got = decode_attention(q, k, v, torch.ones(3, dtype=torch.int32))
    want = torch.repeat_interleave(v[:, :1], 2, dim=2)
    assert (got - want).abs().max().item() < 1e-6


def test_wrapper_checks():
    q, k, v = _case(2, 16, torch.float32)
    kv_len = torch.full((3,), 5, dtype=torch.int32)
    before = dec_ops.launches
    with pytest.raises(ValueError, match="must be 4-D"):
        decode_attention(q[:, 0], k, v, kv_len)
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(q[:, :, :3], k, v, kv_len)        # 3 heads over 2
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(q, k, v[:, :, :1], kv_len)
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(torch.cat([q, q], 1), k, v, kv_len)   # Sq = 2
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, kv_len)
    with pytest.raises(ValueError, match="share one of"):
        decode_attention(q, k.double(), v, kv_len)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, v, kv_len[:2])
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, v, kv_len.float())
    q, k, v = _case(1, 264, torch.float32, B=1, KV=1, S=2)
    with pytest.raises(ValueError, match="hd <= 256"):
        decode_attention(q, k, v, torch.ones(1, dtype=torch.int32))
    assert dec_ops.launches == before


def test_meta_returns_the_empty_result():
    q, k, v = (t.to("meta") for t in _case(2, 16, torch.bfloat16))
    got = decode_attention(q, k, v, torch.ones(3, dtype=torch.int32,
                                               device="meta"))
    assert (got.device.type, got.shape, got.dtype) == (
        "meta", q.shape, torch.bfloat16)


@pytest.mark.parametrize("rows,s_max,want", [
    (128, 4096, (3, 1408)),     # yi-9b.long_decode: 32 slots x 4 kv heads
    (64, 4096, (5, 832)),       # yi-9b.long_prompt: 16 slots
    (4, 32, (1, 64)),           # a smoke config's pool
    (1, 4000, (8, 512)),        # one row: the least chunk
    (1024, 4096, (1, 4096)),    # rows enough to fill the SMs: no split
    (1024, 64, (1, 64)),
])
def test_split_plan(rows, s_max, want):
    splits, chunk = dec_ops.split_plan(rows, s_max, 132)
    assert (splits, chunk) == want
    assert chunk % dec_ops.TILE == 0 and splits * chunk >= s_max
    assert (splits - 1) * chunk < s_max          # no split wholly past S


def test_split_plan_covers_every_length():
    for rows in (1, 3, 16, 100, 1000):
        for s_max in (1, 63, 64, 65, 500, 4096, 32768):
            splits, chunk = dec_ops.split_plan(rows, s_max, 132)
            assert splits * chunk >= s_max > (splits - 1) * chunk
            assert splits <= 65535


def _yi_smoke_params(impl, seed=2):
    cfg = get_config("yi-9b", smoke=True)
    par = ParallelismConfig(compute_dtype="float32", attn_impl=impl)
    params = tlm.Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                         par).init(seed=seed, device="cpu")
    return cfg, par, params


def test_server_flash_decode_equals_ref_on_cpu():
    """The Yi-9B smoke config served with ``attn_impl="flash"`` (B5's and
    the decode kernel's plain versions) emits the ``"ref"`` path's greedy
    tokens: 3 requests on 2 slots, ragged prompts, 8 new tokens each."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, get_config("yi-9b", smoke=True).vocab_size,
                            n).tolist() for n in (16, 5, 9)]
    outs = {}
    for impl in ("ref", "flash"):
        cfg, par, params = _yi_smoke_params(impl)
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=32,
                                               eos_token=-1), SMOKE_MESH,
                     par, device="cpu")
        for p in prompts:
            srv.submit(p, max_new_tokens=8)
        outs[impl] = [r.out_tokens for r in srv.run_until_drained()]
    assert outs["flash"] == outs["ref"]
    assert all(len(t) == 8 for t in outs["flash"])


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_flash_decode_does_not_repeat_the_cache(impl, monkeypatch):
    """``_repeat_kv`` is not reached by a decode step with
    ``attn_impl="flash"``; with ``"ref"`` it is, once for K and once for V
    a layer (so the probe sees the route)."""
    cfg, par, params = _yi_smoke_params(impl)
    tokens = torch.randint(2, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    _, cache = tlm.make_prefill_step(cfg, SMOKE_MESH, par)(
        params, {"tokens": tokens})
    cache = pad_cache(cache, 16)
    calls = []
    real = tattn._repeat_kv

    def probe(x, groups):
        calls.append(groups)
        return real(x, groups)

    monkeypatch.setattr(tattn, "_repeat_kv", probe)
    step = tlm.make_decode_step(cfg, SMOKE_MESH, par)
    logits, cache = step(params, tokens[:, -1:], cache)
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()
    assert calls == ([] if impl == "flash" else [2] * 2 * cfg.n_layers)


def test_attn_apply_decode_routes_by_impl(monkeypatch):
    """One decode layer through ``attn_apply``: the flash route equals the
    ref route (f32), writes the cache in place, and the decode kernel's
    wrapper is what it calls."""
    cfg, _, params = _yi_smoke_params("ref")
    layer = tree_map(lambda a: a[0], params["g0"])["attn"]
    gen = torch.Generator().manual_seed(3)
    B, S_max = 2, 12
    h = torch.randn((B, 1, cfg.d_model), generator=gen)
    outs, called = {}, []
    real = dec_ops.decode_attention

    def spy(*args):
        called.append(args[0].shape)
        return real(*args)

    for impl in ("ref", "flash"):
        cache = {"k": torch.randn((B, S_max, cfg.n_kv_heads, cfg.hd),
                                  generator=torch.Generator().manual_seed(4)),
                 "v": torch.randn((B, S_max, cfg.n_kv_heads, cfg.hd),
                                  generator=torch.Generator().manual_seed(5)),
                 "pos": torch.tensor([3, 11], dtype=torch.int32)}
        ctx = tlayers.Ctx(cfg, SMOKE_MESH, "decode",
                          par=ParallelismConfig(compute_dtype="float32",
                                                attn_impl=impl),
                          positions=cache["pos"].long()[:, None],
                          attn_impl=impl)
        with monkeypatch.context() as m:
            m.setattr(dec_ops, "decode_attention", spy)
            out, new = tattn.attn_apply(layer, h, ctx, cache=cache)
        assert new["k"].data_ptr() == cache["k"].data_ptr()
        assert torch.equal(new["pos"], torch.tensor([4, 12],
                                                    dtype=torch.int32))
        outs[impl] = out
    assert called == [(B, 1, cfg.n_heads, cfg.hd)]
    assert (outs["flash"] - outs["ref"]).abs().max().item() < 1e-5
