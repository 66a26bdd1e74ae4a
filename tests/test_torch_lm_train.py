"""PyTorch port, LM training: the cross-entropy (whole and chunked), the
LM loss and its gradient, B5's gradient, the remat policies, the train
step (plain and donating) and the host target's count of a train step,
each against the JAX package on the ``yi-9b`` (GQA, RMSNorm) and
``stablelm-3b`` (MHA, LayerNorm) smoke configs, with the reference's
parameters carried across by ``convert.params_from_jax``. All on the CPU.

Tolerances: the two packages run the same float32 arithmetic in other
summation orders (XLA's and PyTorch's CPU kernels), which moves a loss of
order 1 by a few 1e-7: the cross-entropy is held within 1e-6 relative, the
loss and every gradient leaf (relative rms) and three AdamW steps within
1e-5. What the port computes two ways on one input (remat policies, the
chunked CE at one chunk, B5's Function against the plain version, the
donating update) is held bit for bit.
"""
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
    from repro.kernels.flash_attention import ops as jflash
    from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref
    from repro.model import lm as jlm
    from repro.optim import adamw as jadamw

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import creator as tcreator
from repro_torch.core import target as ttarget
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.energy import cost as tcost
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.model import lm as tlm
from repro_torch.model.layers import tree_leaves, tree_map, value_and_grad
from repro_torch.optim import adamw as tadamw

ARCHS = ("yi-9b", "stablelm-3b")
S, B = 32, 4


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _jpar(impl="ref"):
    return jtypes.ParallelismConfig(compute_dtype="float32", attn_impl=impl)


def _tpar(impl="ref"):
    return ParallelismConfig(compute_dtype="float32", attn_impl=impl)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, JAX cfg, port params on the CPU, JAX params, batch) for
    one smoke config: params drawn by the reference's Stepper.init, a
    seeded train batch with a few masked targets."""
    arch = request.param
    jcfg = j_get_config(arch, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("t", "train", S, B),
                     jtypes.SMOKE_MESH, _jpar())
    jparams, _ = st.init(seed=5)
    tcfg = get_config(arch, smoke=True)
    tparams = to_torch(params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tcfg), device="cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    targets[rng.random((B, S)) < 0.1] = -1
    return tcfg, jcfg, tparams, jparams, {"tokens": tokens,
                                          "targets": targets}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Cross-entropy
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seq", [700, 1100])
def test_cross_entropy_and_chunked_against_reference(seq):
    rng = np.random.default_rng(seq)
    V, D = 96, 24
    hidden = rng.standard_normal((2, seq, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, (2, seq)).astype(np.int32)
    targets[rng.random((2, seq)) < 0.2] = -1
    logits = hidden @ w
    jl, jn = jlm.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    tl, tn = tlm.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert int(tn) == int(jn) == int((targets >= 0).sum())
    assert tn.dtype == torch.int32
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jl, jn = jlm.chunked_ce_loss(jnp.asarray(hidden), jnp.asarray(targets),
                                 lambda h: h @ jw)
    tl, tn = tlm.chunked_ce_loss(torch.from_numpy(hidden),
                                 torch.from_numpy(targets), lambda h: h @ tw)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert int(tn) == int(jn)


def test_chunked_ce_gradient_against_reference():
    rng = np.random.default_rng(3)
    V, D, seq = 64, 16, 1100
    hidden = rng.standard_normal((2, seq, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    targets = rng.integers(-1, V, (2, seq)).astype(np.int32)
    jt = jnp.asarray(targets)
    jg = jax.grad(lambda h, w_: jlm.chunked_ce_loss(
        h, jt, lambda x: x @ w_)[0], argnums=(0, 1))(jnp.asarray(hidden),
                                                      jnp.asarray(w))
    tt = torch.from_numpy(targets)
    tg = value_and_grad(lambda p: tlm.chunked_ce_loss(
        p["h"], tt, lambda x: x @ p["w"])[0])(
        {"h": torch.from_numpy(hidden), "w": torch.from_numpy(w)})[1]
    assert _rel_rms(_np(tg["h"]), jg[0]) <= 1e-5
    assert _rel_rms(_np(tg["w"]), jg[1]) <= 1e-5


def test_all_masked_targets_count_one_token():
    logits = torch.zeros(1, 3, 8)
    targets = torch.full((1, 3), -1, dtype=torch.int32)
    loss, n = tlm.cross_entropy(logits, targets)
    assert float(loss) == 0.0 and int(n) == 1
    loss, n = tlm.chunked_ce_loss(logits, targets, lambda h: h)
    assert float(loss) == 0.0 and int(n) == 1


# --------------------------------------------------------------------------- #
# The LM loss and its gradient
# --------------------------------------------------------------------------- #


def _loss_and_grads(tcfg, tparams, batch, impl="ref"):
    fn = tlm.make_loss_fn(tcfg, SMOKE_MESH, _tpar(impl))
    return value_and_grad(fn, has_aux=True)(tparams, _tbatch(batch))


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_loss_and_grads_against_reference(model, impl):
    tcfg, jcfg, tparams, jparams, batch = model
    jfn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH, _jpar(impl), None)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jparams, _jbatch(batch))
    (tl, tm), tg = _loss_and_grads(tcfg, tparams, batch, impl)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert int(tm["n_tok"]) == int(jm["n_tok"]) == int(
        (batch["targets"] >= 0).sum())
    assert float(tm["aux"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    worst = max(_rel_rms(_np(t), j) for t, j in zip(tleaves, jleaves))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_and_whole_ce_are_bit_equal(model, remat):
    """The remat policies only choose what the backward recomputes, and at
    one CE chunk the chunked loss is the whole one: losses and gradients
    bit for bit, through the plain attention and through B5."""
    tcfg, _, tparams, _, batch = model
    for impl in ("ref", "flash"):
        (l0, _), g0 = _loss_and_grads(tcfg, tparams, batch, impl)
        for cfg in (tcfg.with_(remat=remat), tcfg.with_(ce_chunked=False)):
            (l1, _), g1 = _loss_and_grads(cfg, tparams, batch, impl)
            assert torch.equal(l0, l1), (cfg.remat, cfg.ce_chunked)
            for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
                assert torch.equal(a, b)


def test_unknown_remat_raises(model):
    tcfg, _, tparams, _, batch = model
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(tcfg.with_(remat="some"), tparams, batch)


def test_long_sequence_chunked_attention_and_ce_gradients():
    """S = 1,100: the plain attention takes its q-chunked path (each chunk
    under a checkpoint) and the CE three chunks, the last one ragged; the
    loss and gradients against the reference's."""
    arch, seq = "stablelm-3b", 1100
    jcfg = j_get_config(arch, smoke=True).with_(n_layers=1)
    tcfg = get_config(arch, smoke=True).with_(n_layers=1)
    jp, _ = jlm.Stepper(jcfg, jtypes.ShapeConfig("t", "train", seq, 1),
                        jtypes.SMOKE_MESH, _jpar()).init(seed=2)
    tp = to_torch(params_from_jax(jax.tree.map(np.asarray, jp), tcfg),
                  device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (1, seq)).astype(np.int32),
             "targets": rng.integers(0, 512, (1, seq)).astype(np.int32)}
    jfn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH, _jpar(), None)
    (jl, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jp, _jbatch(batch))
    (tl, _), tg = _loss_and_grads(tcfg, tp, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    worst = max(_rel_rms(_np(t), j) for t, j in zip(tree_leaves(tg),
                                                    jax.tree.leaves(jg)))
    assert worst <= 1e-5, worst


# --------------------------------------------------------------------------- #
# B5's gradient
# --------------------------------------------------------------------------- #


def _qkv(dtype, shape=(2, 48, 3, 16), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape) * 0.5,
                         dtype=torch.float32).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_is_the_plain_versions(dtype, causal):
    q, k, v, dout = _qkv(dtype)

    def grads(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv, causal)
        return (out, *torch.autograd.grad(out, qkv, dout))

    got, want = grads(flash_attention), grads(attention_ref)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_against_reference_custom_vjp(causal):
    q, k, v, dout = _qkv(torch.float32, (2, 64, 2, 16), seed=1)
    jq, jk, jv, jd = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    jo, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(a, b, c, causal),
                      jq, jk, jv)
    jgrads = vjp(jd)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*qkv, causal)
    tgrads = torch.autograd.grad(out, qkv, dout)
    assert _rel_rms(_np(out), jo) <= 1e-5
    for t, j in zip(tgrads, jgrads):
        assert _rel_rms(_np(t), j) <= 1e-5
    # and the reference's own backward is its plain VJP
    jref = jax.vjp(lambda a, b, c: j_attn_ref(a, b, c, causal),
                   jq, jk, jv)[1](jd)
    for j, r in zip(jgrads, jref):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(r))


def test_flash_backward_on_meta_and_one_op_per_forward():
    q, k, v = (torch.empty(2, 16, 2, 8, device="meta", requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(g.device.type == "meta" and g.shape == q.shape for g in grads)

    def fwd_bwd(q, k, v):
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(flash_attention(*qkv).sum(), qkv)

    for dev in ("meta", "cpu"):
        args = [torch.zeros(2, 16, 2, 8, device=dev) for _ in range(3)]
        cost = tcost.count_step(fwd_bwd, args)
        names = [op.name for op in cost.ops]
        assert names.count("flash_attention") == 1, names
        # the backward's plain VJP is counted op by op
        assert any("bmm" in n for n in names)
        if dev == "meta":
            meta_text = cost.as_text()
        else:
            assert cost.as_text() == meta_text


# --------------------------------------------------------------------------- #
# Train step and optimizer
# --------------------------------------------------------------------------- #


def test_opt_state_schema_mirrors_reference():
    for arch in ARCHS:
        jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            from repro.model.layers import is_pspec as j_is_pspec
            from repro.model.transformer import param_schema as j_schema
        jsch = jadamw.opt_state_schema(j_schema(jcfg, tp=1),
                                       jtypes.SMOKE_MESH)
        tsch = tadamw.opt_state_schema(tlm.param_schema(tcfg))
        from repro_torch.model.layers import is_pspec
        tl = tree_leaves(tsch, is_pspec)
        jl = jax.tree.leaves(jsch, is_leaf=j_is_pspec)
        assert [s.shape for s in tl] == [s.shape for s in jl]
        assert [str(s.dtype).replace("torch.", "") for s in tl] == [
            np.dtype(s.dtype).name for s in jl]
        assert all(s.init == "zeros" for s in tl)


def test_three_train_steps_against_reference(model):
    """Three steps at the reference's default AdamW settings (lr 3e-4
    after 100 warmup steps). Adam divides each gradient component by its
    own magnitude, so a component near 0 (a few 1e-8 here) moves its
    parameter by up to lr whatever the last bits of its sum: at lr 1e-3
    from the first step the embedding leaf differs by 7e-6 relative rms
    after one step, and the next gradients, taken at those parameters,
    by up to 5e-5. Leaf by leaf in relative rms."""
    tcfg, jcfg, tparams, jparams, batch = model
    ocfg = {}
    jstep = jax.jit(jlm.make_train_step(jcfg, jtypes.SMOKE_MESH, _jpar(),
                                        jadamw.AdamWConfig(**ocfg), None))
    tstep = tlm.make_train_step(tcfg, SMOKE_MESH, _tpar(),
                                tadamw.AdamWConfig(**ocfg))
    jp, jo = jparams, jadamw.init_opt_state(jparams)
    tp, to = tparams, tadamw.init_opt_state(tparams)
    for i in range(3):
        b = {k: np.roll(v, i, axis=1) for k, v in batch.items()}
        jp, jo, jm = jstep(jp, jo, _jbatch(b))
        tp, to, tm = tstep(tp, to, _tbatch(b))
        for key in ("loss", "gnorm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(
                float(jm[key])), (i, key)
    for tree_t, tree_j in ((tp, jp), (to["mu"], jo["mu"]),
                           (to["nu"], jo["nu"])):
        for t, j in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel_rms(_np(t), j) <= 1e-5
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donating_update_is_adamw_update_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=9,
                             clip_norm=0.5)

    def tree(scale):
        return {"w": torch.tensor(rng.standard_normal((5, 7)) * scale,
                                  dtype=torch.float32).to(dtype),
                "b": [torch.tensor(rng.standard_normal(7) * scale,
                                   dtype=torch.float32).to(dtype)]}

    params = tree(1.0)
    opt = tadamw.init_opt_state(params)
    p_in, o_in = tree_map(torch.clone, params), tree_map(torch.clone, opt)
    for step in range(4):
        grads = tree(3.0)
        want_p, want_o, want_i = tadamw.adamw_update(grads, opt, params, cfg)
        bufs = [t.data_ptr() for t in tree_leaves((p_in, o_in))]
        got_p, got_o, got_i = tadamw.adamw_update_(
            tree_map(torch.clone, grads), o_in, p_in, cfg)
        assert got_p is p_in and got_o is o_in
        assert [t.data_ptr() for t in tree_leaves((got_p, got_o))] == bufs
        for g, w in zip(tree_leaves((got_p, got_o, got_i)),
                        tree_leaves((want_p, want_o, want_i))):
            assert g.dtype == w.dtype and torch.equal(g, w), step
        params, opt = want_p, want_o


def test_donating_train_step_is_the_plain_one(model):
    tcfg, _, tparams, _, batch = model
    st = tlm.Stepper(tcfg, ShapeConfig("t", "train", S, B), SMOKE_MESH,
                     _tpar("flash"))
    plain, donating = st.train_fn(), st.train_fn(donate=True)
    p0, o0 = tparams, tadamw.init_opt_state(tparams)
    p1, o1 = tree_map(torch.clone, p0), tree_map(torch.clone, o0)
    for _ in range(2):
        p0, o0, m0 = plain(p0, o0, _tbatch(batch))
        p1, o1, m1 = donating(p1, o1, _tbatch(batch))
        for a, b in zip(tree_leaves((p0, o0, m0)), tree_leaves((p1, o1, m1))):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# Counting a train step (the host target)
# --------------------------------------------------------------------------- #


def test_train_step_counts_equal_on_meta_and_cpu():
    cfg = get_config("yi-9b", smoke=True)
    st = tlm.Stepper(cfg, ShapeConfig("t", "train", S, B), SMOKE_MESH,
                     _tpar("flash"))
    meta = tcost.count_step(st.train_fn(),
                            ttarget.abstract_inputs(st, "train"))
    params = st.init(device="cpu")
    batch = {"tokens": torch.zeros(B, S, dtype=torch.int32),
             "targets": torch.ones(B, S, dtype=torch.int32)}
    cpu = tcost.count_step(st.train_fn(), (
        params, tadamw.init_opt_state(params), batch))
    assert cpu.as_text() == meta.as_text()
    assert (cpu.flops, cpu.bytes_accessed, cpu.temp_bytes) == (
        meta.flops, meta.bytes_accessed, meta.temp_bytes)
    names = [op.name for op in meta.ops]
    # a forward and a remat recompute a layer
    assert names.count("flash_attention") == 2 * cfg.n_layers


def test_translate_of_an_lm_train_step():
    cfg = get_config("stablelm-3b", smoke=True)
    shape = ShapeConfig("train_s", "train", S, B)
    cr = tcreator.Creator(device="cpu")
    st = cr.build(cfg, shape, par=_tpar("flash"))
    syn, dep = cr.translate(st)
    assert dep.kind == "train"
    mf = ttarget.model_flops_estimate(cfg, shape)
    assert mf == 6.0 * cfg.param_count() * shape.tokens
    # the counted program also recomputes each block and attends
    assert syn.flops > mf
    params = st.init(device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    args = (params, tadamw.init_opt_state(params), batch)
    cost = tcost.count_step(dep.fn, args)
    assert cost.as_text() == dep.ops_text
    assert (syn.flops, syn.bytes_accessed, syn.argument_bytes,
            syn.output_bytes, syn.temp_bytes) == (
        cost.flops, cost.bytes_accessed, cost.argument_bytes,
        cost.output_bytes, cost.temp_bytes)
    new_params, _, metrics = dep(*args)
    assert torch.isfinite(metrics["loss"]) and metrics["n_tok"] == B * S
