"""PyTorch port, the MoE family: the router (top-k, renormalisation, the
Switch aux loss), the dense expert oracle that every ``impl`` runs on one
device, the loss and its gradients (the router's among them) and the
``Server``, each against the JAX package on the ``deepseek-moe-16b``
(shared experts, a leading dense layer) and ``qwen3-moe-30b-a3b`` (GQA,
qk-norm, no shared experts) smoke configs, with the reference's
parameters carried across by ``convert.params_from_jax``. All in float32
on the CPU.

Tolerances: the two packages run the same float32 arithmetic in other
summation orders, which moves values of order 1 by a few 1e-7. The router
weights are held within 1e-6, its aux loss within 1e-6 relative (the port
counts the assignments per expert and divides once where the reference
scatter-adds ``1/size``), the block outputs and logits within 1e-5, the
loss within 1e-5 relative and each gradient leaf within 1e-5 relative rms.
The ids are held equal on rows without ties; on a tied row the port's own
rule (lowest index first) is pinned, which the reference does not follow.
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
    from repro.configs import get_config as j_get_config
    from repro.core import types as jtypes
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import moe as jmoe
    from repro.runtime import server as jserver

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.types import (SMOKE_MESH, MoEConfig,
                                    ParallelismConfig, ShapeConfig)
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model import moe as tmoe
from repro_torch.model.layers import tree_leaves, value_and_grad
from repro_torch.runtime import server as tserver

ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
TOL = 1e-5


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


def _ctxs(tcfg, jcfg, mode="prefill"):
    tctx = tlayers.Ctx(tcfg, SMOKE_MESH, mode,
                       par=ParallelismConfig(compute_dtype="float32"))
    jctx = jlayers.Ctx(jcfg, jtypes.SMOKE_MESH, mode,
                       par=jtypes.ParallelismConfig(compute_dtype="float32"))
    return tctx, jctx


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, JAX cfg, port params on the CPU, JAX params): the params
    drawn by the reference's Stepper.init."""
    arch = request.param
    jcfg = j_get_config(arch, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jparams, _ = st.init(seed=3)
    tcfg = get_config(arch, smoke=True)
    tparams = to_torch(params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tcfg), device="cpu")
    return tcfg, jcfg, tparams, jparams


def _moe_layer(tparams, jparams, tcfg):
    gi = 1 if tcfg.moe.first_dense else 0
    return (tlayers.tree_map(lambda a: a[0], tparams[f"g{gi}"]["moe"]),
            jax.tree.map(lambda a: a[0], jparams[f"g{gi}"]["moe"]))


# --------------------------------------------------------------------------- #
# Router
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_against_reference_on_tie_free_rows(model, seed):
    tcfg, _, tparams, jparams = model
    tp, jp = _moe_layer(tparams, jparams, tcfg)
    m = tcfg.moe
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, tcfg.d_model)).astype(np.float32)
    tw, ti, ta = tmoe._router(tp, torch.from_numpy(x), m)
    jw, ji, ja = jmoe._router(jp, jnp.asarray(x), m)
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], axis=-1)), axis=-1)
    assert np.all(np.diff(probs, axis=-1) > 0)          # no ties
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, 1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))
    assert ta.dtype == tw.dtype == torch.float32


def test_router_tie_rule_is_lowest_index_first():
    """A row of equal router logits, and one whose k-th place is tied:
    the port takes the lowest expert ids among equals, in order. The
    reference breaks such ties in XLA's own order (ROADMAP §C)."""
    m = MoEConfig(n_experts=64, top_k=6, d_expert=8)
    x = torch.ones((2, 4))
    router = torch.zeros((4, 64))
    router[:, 10] = 0.5                   # row 0: expert 10 first
    p = {"router": router}
    w, i, aux = tmoe._router(p, x, m)
    assert i[0].tolist() == [10, 0, 1, 2, 3, 4]
    flat = tmoe._router({"router": torch.zeros((4, 64))}, x, m)
    assert flat[1][0].tolist() == [0, 1, 2, 3, 4, 5]
    assert torch.allclose(flat[0], torch.full((2, 6), 1 / 6))
    probs = torch.tensor([[.15] * 4 + [.14] * 4 + [.005] * 4])
    vals, idx = tmoe.top_k(probs, 6)
    assert idx[0].tolist() == [0, 1, 2, 3, 4, 5]
    assert vals[0, 4:].tolist() == [probs[0, 4].item()] * 2


# --------------------------------------------------------------------------- #
# moe_dense / moe_apply
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["dense", "psum", "a2a"])
def test_moe_apply_against_reference(model, impl):
    """Every impl runs the dense oracle with no mesh, in both packages."""
    tcfg, jcfg, tparams, jparams = model
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, impl=impl))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, impl=impl))
    tp, jp = _moe_layer(tparams, jparams, tcfg)
    tctx, jctx = _ctxs(tcfg, jcfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 7, tcfg.d_model)).astype(np.float32)
    ty, ta = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, tctx)
    jy, ja = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, jctx)
    _close(ty, jy)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))


@pytest.mark.parametrize("shared", [False, True])
def test_moe_dense_with_and_without_shared_experts(shared):
    """The dense oracle on a config with and without shared experts, from
    one set of seeded numpy params."""
    base = get_config("deepseek-moe-16b", smoke=True)
    m = dict(n_experts=8, top_k=2, d_expert=32,
             n_shared=2 if shared else 0, d_shared=32 if shared else 0)
    tcfg = base.with_(moe=MoEConfig(**m))
    jcfg = j_get_config("deepseek-moe-16b", smoke=True).with_(
        moe=jtypes.MoEConfig(**m))
    sch = tmoe.moe_schema(tcfg)
    assert ("shared" in sch) == shared
    rng = np.random.default_rng(9)
    p = tlayers.tree_map(lambda s: (rng.standard_normal(s.shape)
                                    * s.shape[-2] ** -0.5).astype(np.float32),
                         sch, is_leaf=tlayers.is_pspec)
    tctx, jctx = _ctxs(tcfg, jcfg)
    x = rng.standard_normal((3, 5, tcfg.d_model)).astype(np.float32)
    ty, ta = tmoe.moe_dense(tlayers.tree_map(torch.from_numpy, p),
                            torch.from_numpy(x), tcfg, tctx)
    jy, ja = jmoe.moe_dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg, jctx)
    _close(ty, jy)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))


def test_moe_schema_router_stays_f32_under_a_dtype_override(model):
    tcfg = model[0]
    st = tlm.Stepper(tcfg, ShapeConfig("p", "prefill", 8, 1),
                     SMOKE_MESH, ParallelismConfig(compute_dtype="float32"))
    p = st.init(seed=1, device="cpu", dtype_override=torch.bfloat16)
    gi = 1 if tcfg.moe.first_dense else 0
    assert p[f"g{gi}"]["moe"]["router"].dtype == torch.float32
    assert p[f"g{gi}"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert p[f"g{gi}"]["attn"]["wq"].dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# Loss, aux and gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_loss_aux_and_gradients_against_reference(model, impl):
    tcfg, jcfg, tparams, jparams = model
    rng = np.random.default_rng(11)
    B, S = 2, 16
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, S)),
             "targets": rng.integers(0, tcfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jfn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH, jtypes.ParallelismConfig(
        compute_dtype="float32", attn_impl=impl), None)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = tlm.make_loss_fn(tcfg, SMOKE_MESH, ParallelismConfig(
        compute_dtype="float32", attn_impl=impl))
    (tl, tm), tg = value_and_grad(tfn, has_aux=True)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tm["aux"]) > 0
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-6 * abs(
        float(jm["aux"]))
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    worst = max(_rel_rms(_np(t), j) for t, j in zip(tleaves, jleaves))
    assert worst <= 1e-5, worst
    gi = 1 if tcfg.moe.first_dense else 0
    router = tg[f"g{gi}"]["moe"]["router"]
    assert float(router.abs().max()) > 0              # the gradient gets there
    assert _rel_rms(_np(router), jg[f"g{gi}"]["moe"]["router"]) <= 1e-5


def test_aux_loss_alone_reaches_the_router(model):
    """The aux term's own gradient reaches the router's weights."""
    tcfg, _, tparams, jparams = model
    tp, jp = _moe_layer(tparams, jparams, tcfg)
    x = np.random.default_rng(2).standard_normal(
        (12, tcfg.d_model)).astype(np.float32)
    _, tg = value_and_grad(lambda p: tmoe._router(
        p, torch.from_numpy(x), tcfg.moe)[2])({"router": tp["router"]})
    jg = jax.grad(lambda r: jmoe._router({"router": r}, jnp.asarray(x),
                                         tcfg.moe)[2])(jp["router"])
    assert float(tg["router"].abs().max()) > 0
    assert _rel_rms(_np(tg["router"]), jg) <= 1e-5


# --------------------------------------------------------------------------- #
# Server
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_server_matches_reference_server(model, impl):
    """Identical greedy tokens: 3 requests of 12-token prompts, 4 new
    tokens each, on 2 slots."""
    tcfg, jcfg, tparams, jparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tcfg.vocab_size, 12).tolist()
               for _ in range(3)]
    scfg = dict(batch_slots=2, max_len=24, eos_token=-1)
    tsrv = tserver.Server(tcfg, tparams, tserver.ServerConfig(**scfg),
                          SMOKE_MESH, ParallelismConfig(
                              compute_dtype="float32", attn_impl=impl),
                          device="cpu")
    jsrv = jserver.Server(jcfg, jparams, jserver.ServerConfig(**scfg),
                          jtypes.SMOKE_MESH, jtypes.ParallelismConfig(
                              compute_dtype="float32", attn_impl=impl))
    for srv in (tsrv, jsrv):
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
    t_done, j_done = tsrv.run_until_drained(), jsrv.run_until_drained()
    assert [r.out_tokens for r in t_done] == [r.out_tokens for r in j_done]
    assert all(len(r.out_tokens) == 4 for r in t_done)
