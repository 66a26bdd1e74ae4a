"""PyTorch port, the hybrid family (Zamba2-7B): the config, the Mamba-2
block (``model/ssm.py``: the causal conv and its decode step, the gated
RMS norm, ``mamba_apply`` in prefill, training and decode), the shared
attention block on concat(h, emb0), the ``"shared"`` cache entries, the
whole model's logits, loss and gradients, prefill then decode, a ragged
prompt and the ``Server``, each against the JAX package on the
``zamba2-7b`` smoke config (4 Mamba-2 layers, the shared block after the
2nd and 4th) with the reference's parameters carried across by
``convert.params_from_jax``. All in float32 on the CPU.

The reference's init leaves ``A_log``, ``dt_bias``, ``D`` and the norm
scales constant; they are replaced with seeded random values in both
packages, so that every leaf reaches the result.

Tolerances: 1e-5 absolute on activations and logits (the two packages
sum float32 in other orders, a few 1e-7 on values of order 1), states and
caches within 1e-5 of their leaf's largest magnitude where that exceeds 1
(an SSM state sums a prompt's steps and reaches about 10), the loss within
1e-5 relative and each gradient leaf within 1e-5 relative rms; prefill
then decode against the whole-sequence forward within the reference's
``tests/test_decode_equivalence.py`` bars (2e-3 one step, 5e-3 over
four); the ``Server``'s greedy tokens one for one.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import registry as jregistry
    from repro.core import target as jtarget
    from repro.core import types as jtypes
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import ssm as jssm
    from repro.model import transformer as jtf
    from repro.runtime import server as jserver

import reference_witness
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import registry as tregistry
from repro_torch.core import target as ttarget
from repro_torch.core import types as ttypes
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model import ssm as tssm
from repro_torch.model import transformer as ttf
from repro_torch.model.layers import tree_leaves, value_and_grad
from repro_torch.runtime import server as tserver

ARCH = "zamba2-7b"
IMPLS = ("ref", "flash")
TOL = 1e-5


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


def _close_scaled(got, want, tol=TOL):
    """Within ``tol`` of the leaf's largest magnitude, or of 1 if that is
    smaller."""
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _flat(tree, is_leaf, path=""):
    """{path: leaf} of nested dicts (sorted keys), tuples and lists."""
    if is_leaf(tree) or tree is None:
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], is_leaf, f"{path}/{k}"))
    else:
        for i, t in enumerate(tree):
            out.update(_flat(t, is_leaf, f"{path}/{i}"))
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _pars(impl="ref"):
    return (ParallelismConfig(compute_dtype="float32", attn_impl=impl),
            jtypes.ParallelismConfig(compute_dtype="float32",
                                     attn_impl=impl))


def _ctxs(mode, impl="ref", positions=None):
    tcfg, jcfg = get_config(ARCH, smoke=True), jconfigs.get_config(
        ARCH, smoke=True)
    tpar, jpar = _pars(impl)
    tpos = None if positions is None else torch.from_numpy(positions)
    jpos = None if positions is None else jnp.asarray(positions)
    return (tlayers.Ctx(tcfg, SMOKE_MESH, mode, par=tpar, positions=tpos,
                        attn_impl=impl),
            jlayers.Ctx(jcfg, jtypes.SMOKE_MESH, mode, par=jpar,
                        positions=jpos, attn_impl=impl))


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, port params on the CPU, JAX params): the
    reference's Stepper.init draw, its constant leaves made random."""
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH, _pars()[1])
    jparams, _ = st.init(seed=3)
    rng = np.random.default_rng(26)

    def vary(a):
        a = np.asarray(a, np.float32)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    npar = jax.tree.map(vary, jparams)
    tcfg = get_config(ARCH, smoke=True)
    return (tcfg, jcfg, to_torch(params_from_jax(npar, tcfg), device="cpu"),
            jax.tree.map(jnp.asarray, npar))


def _layer(tparams, jparams, i=0):
    return (tlayers.tree_map(lambda a: a[i], tparams["g0"]),
            jax.tree.map(lambda a: a[i], jparams["g0"]))


def _tokens(n, B=2, seed=0, cfg=None):
    cfg = cfg or get_config(ARCH, smoke=True)
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, n)).astype(np.int32)


# --------------------------------------------------------------------------- #
# Config, counts, schemas, registry
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    t = dataclasses.asdict(get_config(ARCH, smoke=smoke))
    j = dataclasses.asdict(jconfigs.get_config(ARCH, smoke=smoke))
    assert {k: j[k] for k in t} == t
    assert all(j[k] in (None, 0, False) for k in set(j) - set(t)), \
        sorted(set(j) - set(t))


@pytest.mark.parametrize("smoke", [False, True])
def test_counts_shapes_and_flops_equal_the_reference(smoke):
    t, j = get_config(ARCH, smoke=smoke), jconfigs.get_config(ARCH,
                                                              smoke=smoke)
    if not smoke:
        assert t.param_count() == 6_981_758_032
        assert len(t.shared_attn_points()) == 13
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.block_kinds() == j.block_kinds() == ("mamba2",) * t.n_layers
    assert t.shared_attn_points() == j.shared_attn_points()
    assert ttypes.shapes_for(t) == jtypes.shapes_for(j)
    assert ttypes.skipped_shapes_for(t) == jtypes.skipped_shapes_for(j)
    assert ttypes.BLOCK_KINDS == jtypes.BLOCK_KINDS
    assert ttypes.FAMILIES == jtypes.FAMILIES
    for name, shape in ttypes.SHAPES.items():
        assert ttarget.model_flops_estimate(t, shape) == \
            jtarget.model_flops_estimate(j, jtypes.SHAPES[name])


def test_schemas_equal_the_reference_leaf_for_leaf(model):
    """Parameter schemas: shape, dtype, init and scale of every leaf; cache
    schemas: shape and dtype (the port's caches start at zeros)."""
    tcfg, jcfg, _, _ = model
    for params, t_sch, j_sch in (
            (True, ttf.param_schema(tcfg), jtf.param_schema(jcfg)),
            (True, ttf.shared_block_schema(tcfg), jtf.shared_block_schema(
                jcfg, 16)),
            (True, tssm.mamba_schema(tcfg), jssm.mamba_schema(jcfg)),
            (False, tssm.mamba_state_schema(tcfg, 3),
             jssm.mamba_state_schema(jcfg, 3, ("data",))),
            (False, ttf.model_cache_schema(tcfg, 3, 40),
             jtf.model_cache_schema(jcfg, 3, 40, jtypes.SMOKE_MESH))):
        t = _flat(t_sch, tlayers.is_pspec)
        j = _flat(j_sch, jlayers.is_pspec)
        assert sorted(t) == sorted(j)
        for path in t:
            a, b = t[path], j[path]
            assert tuple(a.shape) == tuple(b.shape), path
            assert _dtype_name(a.dtype) == jnp.dtype(b.dtype).name, path
            if params:
                assert (a.init, a.scale) == (b.init, b.scale), path
    cache = ttf.model_cache_schema(tcfg, 3, 40)
    assert len(cache["shared"]) == len(tcfg.shared_attn_points()) == 2


def test_registry_resolves_mamba2_as_the_reference():
    c = tregistry.get("mamba2")
    assert c.ref == "repro_torch.model.ssm.mamba_apply"
    assert c.template == "repro_torch.kernels.mamba2.ops"
    jc = jregistry.get("mamba2")
    assert (c.ref, c.template) == tuple(
        p.replace("repro.", "repro_torch.", 1) for p in (jc.ref, jc.template))
    for smoke in (False, True):
        assert sorted(tregistry.validate_config(get_config(
            ARCH, smoke=smoke))) == sorted(jregistry.validate_config(
                jconfigs.get_config(ARCH, smoke=smoke)))


# --------------------------------------------------------------------------- #
# The block's pieces
# --------------------------------------------------------------------------- #


def test_causal_conv_conv_step_and_gated_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    _close(tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    prev = rng.standard_normal((2, 3, 24)).astype(np.float32)
    ty, tw = tssm._conv_step(torch.from_numpy(x[:, 0]),
                             torch.from_numpy(prev), torch.from_numpy(w))
    jy, jw = jssm._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(prev),
                             jnp.asarray(w))
    _close(ty, jy)
    _close(tw, jw, 0.0)
    z = rng.standard_normal((2, 11, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    _close(tssm._gated_rmsnorm(*(torch.from_numpy(a) for a in (x, z,
                                                                scale))),
           jssm._gated_rmsnorm(*(jnp.asarray(a) for a in (x, z, scale))))


@pytest.mark.parametrize("mode,S", [("prefill", 16), ("prefill", 13),
                                    ("prefill", 2), ("train", 16),
                                    ("decode", 1)])
def test_mamba_apply_against_reference(model, mode, S):
    tcfg, _, tparams, jparams = model
    tp, jp = _layer(tparams, jparams, 1)
    rng = np.random.default_rng(S)
    hx = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    tstate = jstate = None
    if mode == "decode":
        st = {k: (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
              for k, s in tssm.mamba_state_schema(tcfg, 2).items()}
        tstate = {k: torch.from_numpy(v) for k, v in st.items()}
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
    tctx, jctx = _ctxs(mode)
    ty, tst = tssm.mamba_apply(tp["mamba"], torch.from_numpy(hx), tctx,
                               state=tstate)
    jy, jst = jssm.mamba_apply(jp["mamba"], jnp.asarray(hx), jctx,
                               state=jstate)
    _close(ty, jy)
    assert (tst is None) == (jst is None) == (mode == "train")
    if tst is not None:
        assert sorted(tst) == sorted(jst)
        for k in tst:
            _close_scaled(tst[k], jst[k])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_shared_block_against_reference(model, mode):
    tcfg, _, tparams, jparams = model
    rng = np.random.default_rng(7)
    S = 1 if mode == "decode" else 12
    x, emb0 = (rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
               for _ in range(2))
    pos = np.full((2, S), 5, np.int32) if mode == "decode" else \
        np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    tcache = jcache = None
    if mode == "decode":
        kv = {k: (rng.standard_normal((2, 8, tcfg.n_kv_heads, tcfg.hd))
                  ).astype(np.float32) for k in ("k", "v")}
        tcache = dict({k: torch.from_numpy(v.copy()) for k, v in kv.items()},
                      pos=torch.full((2,), 5, dtype=torch.int32))
        jcache = dict({k: jnp.asarray(v) for k, v in kv.items()},
                      pos=jnp.full((2,), 5, jnp.int32))
    tctx, jctx = _ctxs(mode, positions=pos)
    ty, tc = ttf._apply_shared_block(tparams["shared"], torch.from_numpy(x),
                                     torch.from_numpy(emb0), tctx, tcache)
    jy, jc = jtf._apply_shared_block(jparams["shared"], jnp.asarray(x),
                                     jnp.asarray(emb0), jctx, jcache)
    _close(ty, jy)
    for k in ("k", "v", "pos"):
        _close_scaled(tc[k], jc[k])


# --------------------------------------------------------------------------- #
# The whole model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", [16, 13])
def test_prefill_logits_and_cache_against_reference(model, impl, S):
    """S = 13 with the smoke config's chunk 8: a ragged tail in every
    layer's scan."""
    tcfg, jcfg, tparams, jparams = model
    tokens = _tokens(S)
    tpar, jpar = _pars(impl)
    tl, tc = tlm.make_prefill_step(tcfg, SMOKE_MESH, tpar)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    jl, jc = jlm.make_prefill_step(jcfg, jtypes.SMOKE_MESH, jpar)(
        jparams, {"tokens": jnp.asarray(tokens)})
    _close(tl, jl)
    t, j = _flat(tc, torch.is_tensor), _flat(jc, lambda a: isinstance(
        a, jax.Array))
    assert sorted(t) == sorted(j) and any("shared" in k for k in t)
    for k in t:
        _close_scaled(t[k], j[k])



@pytest.mark.parametrize("S", [64, 256])
def test_bf16_drift_from_f32_is_the_references(S):
    """bf16 compute over bf16 weights lies as far from f32 compute in the
    port as in the reference (ROADMAP §C8): one S-token prefill on the
    smoke config at the reference's ``Stepper.init`` draw, last-position
    logits. The port's bf16-vs-f32 relative rms lies within [1/2, 2]
    times the reference's (1.36 and 1.09 times it at S = 64 and 256), its
    bf16 logits within twice that distance of the reference's bf16
    logits, its f32 logits within 1e-5 of the reference's. The same
    reading at full width: ``tests/reference_witness.py bf16-drift
    zamba2-7b <layers> <S>``."""
    cfg = get_config(ARCH, smoke=True)
    read = reference_witness.bf16_drift(ARCH, cfg.n_layers, S, smoke=True)
    drift = read["ref bf16 vs ref f32"]
    assert 0.5 * drift <= read["port bf16 vs port f32"] <= 2 * drift, read
    assert read["port bf16 vs ref bf16"] <= 2 * drift, read
    assert read["port f32 vs ref f32"] <= TOL, read

@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_gradients_against_reference(model, impl):
    tcfg, jcfg, tparams, jparams = model
    rng = np.random.default_rng(11)
    B, S = 2, 16
    batch = {k: rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    tpar, jpar = _pars(impl)
    jfn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH, jpar, None)
    (jl, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = tlm.make_loss_fn(tcfg, SMOKE_MESH, tpar)
    (tl, _), tg = value_and_grad(tfn, has_aux=True)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    worst = max(_rel_rms(_np(t), j) for t, j in zip(tleaves, jleaves))
    assert worst <= 1e-5, worst
    assert float(tg["shared"]["attn"]["wq"].abs().max()) > 0


def test_training_runs_the_chunked_form_not_the_kernel(model, monkeypatch):
    """B6 is forward-only: a train step's scan is ``ssd_chunked`` on every
    device; a CPU prefill's too."""
    tcfg, _, tparams, _ = model

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(ssd_ops, "ssd", refuse)
    batch = {k: torch.from_numpy(_tokens(16)) for k in ("tokens", "targets")}
    tlm.make_loss_fn(tcfg, SMOKE_MESH, _pars()[0])(tparams, batch)
    tlm.make_prefill_step(tcfg, SMOKE_MESH, _pars()[0])(
        tparams, {"tokens": batch["tokens"]})


@pytest.mark.parametrize("S,chunk", [(13, 8), (16, 8), (5, 8), (40, 16)])
def test_kernel_seam_pads_a_ragged_tail_with_identity_steps(S, chunk):
    """``_ssd_kernel`` (the CUDA prefill's path, here through B6's
    wrapper's plain version) on a ragged S: the dt = 0 tail leaves y and
    the final state equal to the reference's ``ssd_chunked`` on the
    unpadded input."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, 1, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    ty, th = tssm._ssd_kernel(*(torch.from_numpy(a) for a in (
        x, dt, A, Bm, Cm)), min(chunk, S), torch.from_numpy(h0))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              chunk=min(chunk, S), h0=jnp.asarray(h0))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_prefill_then_decode_matches_the_full_forward(model):
    """The reference's test_decode_equivalence bars: one decode step after
    a 16-token prefill within 2e-3 of the 17-token forward's last logits,
    and each of 4 steps after 12 within 5e-3; the decode logits also
    within 1e-5 of the reference's decode."""
    tcfg, jcfg, tparams, jparams = model
    tpar, jpar = _pars()
    pre = tlm.make_prefill_step(tcfg, SMOKE_MESH, tpar)
    dec = tlm.make_decode_step(tcfg, SMOKE_MESH, tpar)
    jpre = jlm.make_prefill_step(jcfg, jtypes.SMOKE_MESH, jpar)
    jdec = jlm.make_decode_step(jcfg, jtypes.SMOKE_MESH, jpar)
    toks = _tokens(17, seed=4)
    full, _ = pre(tparams, {"tokens": torch.from_numpy(toks)})
    _, cache = pre(tparams, {"tokens": torch.from_numpy(toks[:, :16])})
    logits, _ = dec(tparams, torch.from_numpy(toks[:, 16:]),
                    ttf.pad_cache(cache, 20))
    assert float((full - logits).abs().max()) < 2e-3
    _, jc = jpre(jparams, {"tokens": jnp.asarray(toks[:, :16])})
    jlog, _ = jdec(jparams, jnp.asarray(toks[:, 16:]), jtf.pad_cache(jc, 20))
    _close(logits, jlog)

    toks = _tokens(16, seed=5)
    _, cache = pre(tparams, {"tokens": torch.from_numpy(toks[:, :12])})
    cache = ttf.pad_cache(cache, 18)
    assert cache["shared"][0]["k"].shape[1] == 18
    for t in range(4):
        logits, cache = dec(tparams,
                            torch.from_numpy(toks[:, 12 + t:13 + t]), cache)
        want, _ = pre(tparams, {"tokens": torch.from_numpy(
            toks[:, :13 + t])})
        assert float((want - logits).abs().max()) < 5e-3, t


@pytest.mark.parametrize("impl", IMPLS)
def test_server_matches_reference_server(model, impl):
    """Identical greedy tokens: 3 requests (prompts of 12, 13 and 7
    tokens), 4 new tokens each, on 2 slots."""
    tcfg, jcfg, tparams, jparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tcfg.vocab_size, n).tolist()
               for n in (12, 13, 7)]
    scfg = dict(batch_slots=2, max_len=24, eos_token=-1)
    tpar, jpar = _pars(impl)
    tsrv = tserver.Server(tcfg, tparams, tserver.ServerConfig(**scfg),
                          SMOKE_MESH, tpar, device="cpu")
    jsrv = jserver.Server(jcfg, jparams, jserver.ServerConfig(**scfg),
                          jtypes.SMOKE_MESH, jpar)
    for srv in (tsrv, jsrv):
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
    t_done, j_done = tsrv.run_until_drained(), jsrv.run_until_drained()
    assert [r.out_tokens for r in t_done] == [r.out_tokens for r in j_done]
    assert all(len(r.out_tokens) == 4 for r in t_done)


def test_stepper_init_and_server_from_the_ports_own_draw():
    """The port's own init (bf16 weights, f32 compute) serves too, and the
    decode positions come from the first shared block's cache."""
    cfg = get_config(ARCH, smoke=True)
    st = tlm.Stepper(cfg, ShapeConfig("p", "prefill", 16, 1), SMOKE_MESH,
                     _pars()[0])
    p = st.init(seed=0, device="cpu", dtype_override=torch.bfloat16)
    assert p["shared"]["attn"]["wq"].shape == (2 * cfg.d_model,
                                               cfg.n_heads * cfg.hd)
    srv = tserver.Server(cfg, p, tserver.ServerConfig(
        batch_slots=2, max_len=20, eos_token=-1), SMOKE_MESH, _pars()[0],
        device="cpu")
    srv.submit(list(range(2, 9)), max_new_tokens=3)
    done = srv.run_until_drained()
    assert len(done[0].out_tokens) == 3
    cache = srv._cache
    assert [int(v) for v in cache["shared"][0]["pos"]] == [9, 9]
    assert ttf._decode_positions(cfg, cache, 2, "cpu") is \
        cache["shared"][0]["pos"]
