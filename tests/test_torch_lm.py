"""PyTorch port, the dense-LM serving slice as a whole: norms, RoPE, MLP,
attention (prefill and decode, plain and B5), the whole model's prefill
and decode, and the ``Server``, each against the JAX package on the
``yi-9b`` (GQA, RMSNorm) and ``stablelm-3b`` (MHA, LayerNorm) smoke
configs, with the reference's parameters carried across by
``convert.params_from_jax``. All in float32 on the CPU.

Tolerance: 1e-5 absolute on every activation, logit and cache entry. The
two packages run the same float32 arithmetic in other summation orders
(XLA's and PyTorch's CPU matmuls), which moves values of order 1 by a few
1e-7; nothing is looser.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro/shardmap.py reads jax.lax.pvary, which jax 0.9 deprecates, and
# pytest.ini turns a DeprecationWarning raised from repro into an error:
# import the reference's LM modules with that warning silenced.
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import get_config as j_get_config
    from repro.core import types as jtypes
    from repro.model import attention as jattn
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import transformer as jtf
    from repro.runtime import server as jserver

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.model import attention as tattn
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model import transformer as ttf
from repro_torch.runtime import server as tserver

ARCHS = ("yi-9b", "stablelm-3b")
IMPLS = ("ref", "flash")
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, JAX cfg, port params on the CPU, JAX params) for one
    smoke config, the params drawn by the reference's Stepper.init."""
    arch = request.param
    jcfg = j_get_config(arch, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jparams, _ = st.init(seed=3)
    tparams = to_torch(params_from_jax(
        jax.tree.map(np.asarray, jparams), get_config(arch, smoke=True)),
        device="cpu")
    return get_config(arch, smoke=True), jcfg, tparams, jparams


def _ctxs(tcfg, jcfg, mode, impl, positions):
    tctx = tlayers.Ctx(tcfg, SMOKE_MESH, mode,
                       par=ParallelismConfig(compute_dtype="float32",
                                             attn_impl=impl),
                       positions=torch.from_numpy(positions),
                       attn_impl=impl)
    jctx = jlayers.Ctx(jcfg, jtypes.SMOKE_MESH, mode,
                       par=jtypes.ParallelismConfig(
                           compute_dtype="float32", attn_impl=impl),
                       positions=jnp.asarray(positions), attn_impl=impl)
    return tctx, jctx


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["g0"])


def test_schema_matches_reference_leaf_for_leaf(model):
    tcfg, jcfg, _, _ = model
    for port, ref in ((ttf.param_schema(tcfg), jtf.param_schema(jcfg, tp=1)),
                      (ttf.model_cache_schema(tcfg, 3, 40),
                       jtf.model_cache_schema(jcfg, 3, 40, jtypes.SMOKE_MESH,
                                              tp=1))):
        shapes = [s.shape for s in tlayers.tree_leaves(port,
                                                       tlayers.is_pspec)]
        assert shapes == [s.shape for s in jax.tree.leaves(
            ref, is_leaf=jlayers.is_pspec)]
    shape = ShapeConfig("d", "decode", 40, 3)
    jspecs = jlm.input_specs(jcfg, jtypes.ShapeConfig("d", "decode", 40, 3))
    assert {k: v[0] for k, v in tlm.input_specs(tcfg, shape).items()} == {
        k: v.shape for k, v in jspecs.items()}


def test_norms_rope_and_mlp(model):
    tcfg, jcfg, tp, jp = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8), (2, 5)).astype(np.int32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill", "ref", pos)
    tl, jl = tlayers.tree_map(lambda a: a[1], tp["g0"]), _layer(jp, 1)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tlayers.apply_norm(tl["norm1"], tx, tcfg),
           jlayers.apply_norm(jl["norm1"], jx, jcfg))
    _close(tlayers.apply_norm(tp["final_norm"], tx, tcfg),
           jlayers.apply_norm(jp["final_norm"], jx, jcfg))
    scale = rng.standard_normal(16).astype(np.float32)
    xh = x.reshape(2, 5, -1, 16)
    _close(tlayers.rms_head_norm(torch.from_numpy(scale),
                                 torch.from_numpy(xh)),
           jlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(xh)))
    tcs = tlayers.rope_angles(torch.from_numpy(pos), 16, tcfg.rope_theta)
    jcs = jlayers.rope_angles(jnp.asarray(pos), 16, jcfg.rope_theta)
    for t, j in zip(tcs, jcs):
        _close(t, j)
    _close(tlayers.apply_rope(torch.from_numpy(xh), *tcs),
           jlayers.apply_rope(jnp.asarray(xh), *jcs))
    _close(tlayers.apply_mlp(tl["mlp"], tx, tcfg, tctx),
           jlayers.apply_mlp(jl["mlp"], jx, jcfg, jctx))
    tokens = rng.integers(0, tcfg.vocab_size, (2, 5))
    h = tlayers.embed_tokens(tp["embed"], torch.from_numpy(tokens), tcfg,
                             tctx)
    _close(h, jlayers.embed_tokens(jp["embed"], jnp.asarray(tokens), jcfg,
                                   jctx))
    _close(tlayers.lm_logits(tp["embed"], tx, tcfg, tctx),
           jlayers.lm_logits(jp["embed"], jx, jcfg, jctx))


@pytest.mark.parametrize("act", ["gelu", "relu_sq"])
def test_two_matrix_mlp(act):
    """The 2-matrix MLP variants (no dense config here uses them yet)."""
    tcfg = get_config("yi-9b", smoke=True).with_(act=act)
    jcfg = j_get_config("yi-9b", smoke=True).with_(act=act)
    rng = np.random.default_rng(6)
    p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
         for k, s in tlayers.mlp_schema(tcfg).items()}
    assert sorted(p) == ["wi", "wo"]
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill", "ref", np.zeros((2, 3),
                                                             np.int32))
    _close(tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), tcfg, tctx),
           jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg, jctx))


@pytest.mark.parametrize("impl", IMPLS)
def test_attn_apply_prefill_then_decode(model, impl):
    tcfg, jcfg, tp, jp = model
    rng = np.random.default_rng(1)
    B, S, S_max = 2, 16, 20
    h = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill", impl, pos)
    tl, jl = tlayers.tree_map(lambda a: a[0], tp["g0"]), _layer(jp, 0)
    t_out, t_cache = tattn.attn_apply(tl["attn"], torch.from_numpy(h), tctx)
    j_out, j_cache = jattn.attn_apply(jl["attn"], jnp.asarray(h), jctx)
    _close(t_out, j_out)
    for key in ("k", "v", "pos"):
        _close(t_cache[key], j_cache[key])
    # decode one token at position S over caches padded to S_max
    t_cache = ttf.pad_cache({"layers": (t_cache,)}, S_max)["layers"][0]
    j_cache = jtf.pad_cache({"layers": (j_cache,)}, S_max)["layers"][0]
    h1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    dpos = np.full((B, 1), S, np.int32)
    tctx, jctx = _ctxs(tcfg, jcfg, "decode", impl, dpos)
    t_out, t_new = tattn.attn_apply(tl["attn"], torch.from_numpy(h1), tctx,
                                    cache=t_cache)
    j_out, j_new = jattn.attn_apply(jl["attn"], jnp.asarray(h1), jctx,
                                    cache=j_cache)
    _close(t_out, j_out)
    for key in ("k", "v", "pos"):
        _close(t_new[key], j_new[key])
    assert t_new["k"].data_ptr() == t_cache["k"].data_ptr()   # in place


@pytest.mark.parametrize("grouped", [False, True])
def test_attention_core_chunked_and_grouped(model, grouped, monkeypatch):
    """The q-chunked long-sequence path (thresholds shrunk in both
    packages) and the grouped-GQA block against unrepeated K/V."""
    tcfg, jcfg, _, _ = model
    for mod in (tattn, jattn):
        monkeypatch.setattr(mod, "FULL_ATTN_MAX_SEQ", 8)
        monkeypatch.setattr(mod, "Q_CHUNK", 4)
    rng = np.random.default_rng(2)
    H, KV, hd, S = tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, 13
    q = rng.standard_normal((2, S, H, hd)).astype(np.float32)
    kv_heads = KV if grouped else H
    k, v = (rng.standard_normal((2, S, kv_heads, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.zeros((2, S), np.int32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill", "ref", pos)
    for causal in (True, False):
        _close(tattn.attention_core(*map(torch.from_numpy, (q, k, v)), tctx,
                                    causal=causal),
               jattn.attention_core(*map(jnp.asarray, (q, k, v)), jctx,
                                    causal=causal))


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_model_prefill_then_decode(model, impl):
    tcfg, jcfg, tp, jp = model
    rng = np.random.default_rng(4)
    B, S, S_max = 2, 16, 24
    tokens = rng.integers(0, tcfg.vocab_size, (B, S))
    tctx = tlayers.Ctx(tcfg, SMOKE_MESH, "prefill",
                       par=ParallelismConfig(compute_dtype="float32",
                                             attn_impl=impl),
                       attn_impl=impl)
    jctx = jlayers.Ctx(jcfg, jtypes.SMOKE_MESH, "prefill",
                       par=jtypes.ParallelismConfig(
                           compute_dtype="float32", attn_impl=impl),
                       attn_impl=impl)
    t_logits, t_cache, _ = ttf.apply_model(
        tp, {"tokens": torch.from_numpy(tokens)}, tctx)
    j_logits, j_cache, _ = jtf.apply_model(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, jctx)
    _close(t_logits, j_logits)
    assert len(t_cache["layers"]) == tcfg.n_layers
    for tc, jc in zip(t_cache["layers"], j_cache["layers"]):
        for key in ("k", "v", "pos"):
            _close(tc[key], jc[key])
    # one decode step through the step builders over padded caches
    nxt = rng.integers(0, tcfg.vocab_size, (B, 1))
    par_t = ParallelismConfig(compute_dtype="float32", attn_impl=impl)
    par_j = jtypes.ParallelismConfig(compute_dtype="float32",
                                     attn_impl=impl)
    t_dec, t_new = tlm.make_decode_step(tcfg, SMOKE_MESH, par_t)(
        tp, torch.from_numpy(nxt), ttf.pad_cache(t_cache, S_max))
    j_dec, j_new = jlm.make_decode_step(jcfg, jtypes.SMOKE_MESH, par_j)(
        jp, jnp.asarray(nxt, jnp.int32), jtf.pad_cache(j_cache, S_max))
    _close(t_dec, j_dec)
    for tc, jc in zip(t_new["layers"], j_new["layers"]):
        for key in ("k", "v", "pos"):
            _close(tc[key], jc[key])
    # the prefill step returns the last position's logits
    t_last, _ = tlm.make_prefill_step(tcfg, SMOKE_MESH, par_t)(
        tp, {"tokens": torch.from_numpy(tokens)})
    _close(t_last, j_logits[:, -1])


@pytest.mark.parametrize("impl", IMPLS)
def test_server_matches_reference_server(model, impl):
    """Identical greedy tokens and identical ServerStats counters: 3
    requests of 16-token prompts, 5 new tokens each, on 2 slots."""
    tcfg, jcfg, tp, jp = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tcfg.vocab_size, 16).tolist()
               for _ in range(3)]
    scfg = dict(batch_slots=2, max_len=32, eos_token=-1)
    tsrv = tserver.Server(tcfg, tp, tserver.ServerConfig(**scfg), SMOKE_MESH,
                          ParallelismConfig(compute_dtype="float32",
                                            attn_impl=impl),
                          device="cpu")
    jsrv = jserver.Server(jcfg, jp, jserver.ServerConfig(**scfg),
                          jtypes.SMOKE_MESH,
                          jtypes.ParallelismConfig(
                              compute_dtype="float32", attn_impl=impl))
    for srv in (tsrv, jsrv):
        for p in prompts:
            srv.submit(p, max_new_tokens=5)
    t_done, j_done = tsrv.run_until_drained(), jsrv.run_until_drained()
    assert [r.out_tokens for r in t_done] == [r.out_tokens for r in j_done]
    assert all(len(r.out_tokens) == 5 for r in t_done)
    keep = ("ticks", "submitted", "admitted", "retired", "max_queue_depth",
            "max_slots_busy")
    t_stats, j_stats = dataclasses.asdict(t_done.stats), dataclasses.asdict(
        j_done.stats)
    assert {k: t_stats[k] for k in keep} == {k: j_stats[k] for k in keep}
    assert t_stats["ttft_s"]["count"] == j_stats["ttft_s"]["count"] == 3


def test_stepper_init_draws_seeded_params_on_the_device():
    cfg = get_config("yi-9b", smoke=True)
    st = tlm.Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                     ParallelismConfig(compute_dtype="float32"))
    a = st.init(seed=7, device="cpu")
    b = st.init(seed=7, device="cpu", dtype_override=torch.bfloat16)
    wq = a["g0"]["attn"]["wq"]
    assert wq.shape == (2, 64, 64) and wq.dtype == torch.float32
    assert torch.equal(wq.to(torch.bfloat16), b["g0"]["attn"]["wq"])
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02      # fan-in normal
    assert torch.equal(a["g0"]["norm1"]["scale"], torch.ones(2, 64))
    emb = a["embed"]["embedding"]
    assert emb.shape == (512, 64) and abs(float(emb.std()) - 0.02) < 0.002
    if not torch.cuda.is_available():        # no device means CUDA, or raise
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.init(seed=7)


def _jax_tree(cfg_arch):
    jcfg = j_get_config(cfg_arch, smoke=True)
    sch = jtf.param_schema(jcfg, tp=1)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), sch,
                        is_leaf=jlayers.is_pspec)


def test_convert_rejects_a_wrong_key_with_its_path():
    cfg = get_config("yi-9b", smoke=True)
    tree = _jax_tree("yi-9b")
    tree["g0"]["attn"]["wqq"] = tree["g0"]["attn"].pop("wq")
    with pytest.raises(KeyError, match=r"params\['g0'\]\['attn'\]: missing "
                                       r"keys \['wq'\], unexpected keys "
                                       r"\['wqq'\]"):
        params_from_jax(tree, cfg)


def test_convert_rejects_a_wrong_stacked_shape_with_its_path():
    cfg = get_config("yi-9b", smoke=True)
    tree = _jax_tree("yi-9b")
    tree["g0"]["mlp"]["wo"] = tree["g0"]["mlp"]["wo"][:1]   # one layer of 2
    with pytest.raises(ValueError, match=r"params\['g0'\]\['mlp'\]\['wo'\]: "
                                         r"shape \(1, 128, 64\) != schema "
                                         r"\(2, 128, 64\)"):
        params_from_jax(tree, cfg)
    ok = params_from_jax(_jax_tree("yi-9b"), cfg)
    assert ok["g0"]["mlp"]["wo"].shape == (2, 128, 64)
