"""PyTorch port, Stage-1 training (main-path stage 6, first half) against
the JAX package on the CPU: the clip gradient at ties, the straight-through
fake-quant, the float and QAT forwards of the paper's two designs, their
losses and gradients, AdamW, the data pipeline, the shape tables, and a
short QAT run of the example's ``lstm_train_fn`` lowered to the RTL IR.

Inputs are made from a seed with numpy; the reference's parameters carry
across with ``convert.params_from_jax``. The reference runs here, in the
test: its modules (and ``examples/elastic_workflow.py``) are imported with
the jax 0.9 deprecation warning silenced, which ``pytest.ini`` would
otherwise turn into a collection error.

Tolerances: forwards within 1e-6, losses and gradients within 1e-5, one
AdamW update within 1e-6, 20 float AdamW steps within 1e-5, the short QAT
run's losses within 1e-4, ``quant_error`` (an f32 mean) within 1e-6
relative; fake-quant values and gradients, the data and the shape tables
exactly.
"""
import importlib.util
import math
import os
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
    from repro.data import pipeline as jdata
    from repro.model import conv1d as jconv
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import lstm as jlstm
    from repro.optim import adamw as jadamw
    from repro.quant import fixedpoint as jfxp
    from repro.quant import qat as jqat
    from repro.rtl import ir as jir

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import target as ttarget
from repro_torch.core import types as ttypes
from repro_torch.data import pipeline as tdata
from repro_torch.launch import elastic_workflow as tew
from repro_torch.model import conv1d as tconv
from repro_torch.model import lm as tlm
from repro_torch.model import lstm as tlstm
from repro_torch.model import transformer as ttf
from repro_torch.model.layers import tree_leaves, tree_map, value_and_grad
from repro_torch.optim import adamw as tadamw
from repro_torch.quant import fixedpoint as tfxp
from repro_torch.quant import qat as tqat
from repro_torch.rtl import ir as tir
from repro_torch.rtl.backend import RTL_TARGET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("elastic-lstm", "elastic-conv1d")
FMTS = ((8, 6), (8, 4), (16, 8), (4, 2), (12, 8))


def _example():
    """``examples/elastic_workflow.py``, the reference's Stage-1 script."""
    spec = importlib.util.spec_from_file_location(
        "_ref_elastic_workflow",
        os.path.join(ROOT, "examples", "elastic_workflow.py"))
    mod = importlib.util.module_from_spec(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec.loader.exec_module(mod)
    return mod


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _ref_params(arch, seed=0):
    """The reference's initial parameters and the port's copy of them."""
    jcfg = j_get_config(arch)
    jp = jlayers.init_params(jlm.param_schema(jcfg),
                             jax.random.PRNGKey(seed))
    return jp, to_torch(params_from_jax(jp, get_config(arch)), "cpu")


def _max_leaf_diff(jtree, ttree) -> float:
    j = jax.tree.leaves(jtree)
    t = tree_leaves(ttree)
    assert len(j) == len(t)
    return max(float(np.max(np.abs(np.asarray(a) - _np(b)))) if np.size(a)
               else 0.0 for a, b in zip(j, t))


def _window_batch(arch, batch, seed):
    rng = np.random.default_rng(seed)
    cfg = get_config(arch)
    if arch == "elastic-lstm":
        shape = (batch, cfg.lstm.seq_len, cfg.lstm.in_features)
    else:
        shape = (batch, cfg.conv1d.seq_len, cfg.conv1d.channels)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal((batch, 1)).astype(np.float32)
    return {"x": x, "y": y}


# --------------------------------------------------------------------------- #
# The clip gradient at ties (the repair of hard_sigmoid / hard_tanh)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,points", [
    ("hard_sigmoid", (-2.5, 2.5, -3.0, 0.0, 1.25, 2.75)),
    ("hard_tanh", (-1.0, 1.0, -1.5, 0.0, 0.5, 1.25))])
def test_hard_activation_gradient_at_ties_is_jax_grad(name, points):
    jfn, tfn = getattr(jqat, name), getattr(tqat, name)
    for p in points:
        want = float(jax.grad(lambda v: jfn(v))(jnp.float32(p)))
        x = torch.tensor(p, dtype=torch.float32, requires_grad=True)
        (got,) = torch.autograd.grad(tfn(x), x)
        assert float(got) == want, (name, p, float(got), want)
    ties = points[:2]
    halves = [float(jax.grad(jfn)(jnp.float32(p))) for p in ties]
    half = np.float32(0.1) if name == "hard_sigmoid" else np.float32(0.5)
    assert halves == [float(half)] * 2, halves


@pytest.mark.parametrize("name", ["hard_sigmoid", "hard_tanh"])
def test_hard_activation_forward_bit_for_bit(name):
    x = np.random.default_rng(1).uniform(-4, 4, 4096).astype(np.float32)
    x[:4] = (-2.5, 2.5, -1.0, 1.0)
    want = np.asarray(getattr(jqat, name)(jnp.asarray(x)))
    got = getattr(tqat, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# The straight-through fake-quant
# --------------------------------------------------------------------------- #


def _edge_inputs(fmt_t, seed):
    """Random values plus every saturation edge and half-LSB tie of the
    format, in codes: lo, hi, lo - 1/2, hi + 1/2, k + 1/2, and the values
    just inside and outside the inclusive [lo, hi] of the STE mask."""
    tb, fb = fmt_t
    scale, lo, hi = 2.0 ** fb, -(2 ** (tb - 1)), 2 ** (tb - 1) - 1
    rng = np.random.default_rng(seed)
    codes = np.concatenate([
        [lo, hi, lo - 0.5, hi + 0.5, lo - 1, hi + 1, 0.5, -0.5, 1.5, -1.5,
         lo + 0.5, hi - 0.5],
        np.nextafter(np.float32(lo), np.float32(-1e9), dtype=np.float32)[None],
        np.nextafter(np.float32(hi), np.float32(1e9), dtype=np.float32)[None],
        rng.integers(lo, hi, 32) + 0.5,
        rng.uniform(lo - 8, hi + 8, 256)])
    return (codes / scale).astype(np.float32)


@pytest.mark.parametrize("fmt_t", FMTS)
def test_fake_quant_values_and_ste_gradients_equal(fmt_t):
    x = _edge_inputs(fmt_t, seed=sum(fmt_t))
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    jf, tf = jfxp.FxpFormat(*fmt_t), tfxp.FxpFormat(*fmt_t)
    jval, jvjp = jax.vjp(lambda v: jfxp.fake_quant(v, jf), jnp.asarray(x))
    (jgrad,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tval = tfxp.fake_quant(xt, tf)
    (tgrad,) = torch.autograd.grad(tval, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(tval.detach().numpy(), np.asarray(jval))
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    # the mask really is inclusive at both ends and zero outside
    assert tgrad[0] == g[0] and tgrad[1] == g[1] and tgrad[4] == 0.0


@pytest.mark.parametrize("fmt_t", FMTS)
def test_pick_frac_bits_and_quant_error_equal(fmt_t):
    x = np.random.default_rng(3).standard_normal(300).astype(np.float32) \
        * fmt_t[1]
    for v in (x, np.zeros(4, np.float32), x * 1e-3, x * 300):
        assert tfxp.pick_frac_bits(torch.from_numpy(v), fmt_t[0]) == \
            jfxp.pick_frac_bits(jnp.asarray(v), fmt_t[0])
    # an f32 mean over 300 squares: the summation orders differ
    assert tfxp.quant_error(torch.from_numpy(x), tfxp.FxpFormat(*fmt_t)) \
        == pytest.approx(jfxp.quant_error(jnp.asarray(x),
                                          jfxp.FxpFormat(*fmt_t)), rel=1e-6)
    f = tfxp.FxpFormat(*fmt_t)
    assert (f.resolution, f.max_value) == (
        jfxp.FxpFormat(*fmt_t).resolution, jfxp.FxpFormat(*fmt_t).max_value)


# --------------------------------------------------------------------------- #
# Forwards at Table I, batch 64, with and without a given state
# --------------------------------------------------------------------------- #


def _state(seed, batch=64):
    rng = np.random.default_rng(seed)
    hidden = get_config("elastic-lstm").lstm.hidden
    return tuple((rng.uniform(-1, 1, (batch, hidden)).astype(np.float32),
                  rng.uniform(-2, 2, (batch, hidden)).astype(np.float32))
                 for _ in range(get_config("elastic-lstm").lstm.n_layers))


def _quantized_state(seed):
    """A state that lies on the QAT grid, as a running QAT cell carries it:
    h on the activation format, c on the accumulator's."""
    q = lambda a, s: (np.round(a * s) / s).astype(np.float32)   # noqa: E731
    return tuple((q(h, 16), q(c, 256)) for h, c in _state(seed))


def _assert_forward(jout, tout, tol=1e-6):
    (jpred, jst), (tpred, tst) = jout, tout
    err = float(np.max(np.abs(np.asarray(jpred) - _np(tpred))))
    assert err <= tol, err
    assert len(jst) == len(tst)
    for (jh, jc), (th, tc) in zip(jst, tst):
        assert float(np.max(np.abs(np.asarray(jh) - _np(th)))) <= tol
        assert float(np.max(np.abs(np.asarray(jc) - _np(tc)))) <= tol


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_apply_forward(with_state):
    jp, tp = _ref_params("elastic-lstm", seed=3)
    b = _window_batch("elastic-lstm", 64, seed=4)
    st = _state(5) if with_state else None
    jst = None if st is None else tuple((jnp.asarray(h), jnp.asarray(c))
                                        for h, c in st)
    tst = None if st is None else tuple((torch.from_numpy(h),
                                         torch.from_numpy(c))
                                        for h, c in st)
    jout = jlstm.lstm_apply(jp, jnp.asarray(b["x"]),
                            j_get_config("elastic-lstm"), jst)
    tout = tlstm.lstm_apply(tp, torch.from_numpy(b["x"]),
                            get_config("elastic-lstm"), tst)
    _assert_forward(jout, tout)


def test_conv1d_apply_forward():
    jp, tp = _ref_params("elastic-conv1d", seed=3)
    b = _window_batch("elastic-conv1d", 64, seed=4)
    jpred, jst = jconv.conv1d_apply(jp, jnp.asarray(b["x"]),
                                    j_get_config("elastic-conv1d"))
    tpred, tst = tconv.conv1d_apply(tp, torch.from_numpy(b["x"]),
                                    get_config("elastic-conv1d"))
    assert jst == () and tst == ()
    assert float(np.max(np.abs(np.asarray(jpred) - _np(tpred)))) <= 1e-6
    for stride in (1, 2, 3):
        x = np.random.default_rng(stride).standard_normal(
            (5, 16, 3)).astype(np.float32)
        w = np.random.default_rng(9).standard_normal((4, 3)) \
            .astype(np.float32)
        bias = np.arange(3, dtype=np.float32)
        want = jconv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias), stride)
        got = tconv.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(bias), stride)
        assert float(np.max(np.abs(np.asarray(want) - _np(got)))) <= 1e-6
    for arch in ARCHS:
        assert tconv.conv1d_flops(get_config("elastic-conv1d")) == \
            jconv.conv1d_flops(j_get_config("elastic-conv1d"))
        assert tlstm.lstm_flops(get_config("elastic-lstm")) == \
            jlstm.lstm_flops(j_get_config("elastic-lstm"))


def _qcfgs(hard, quant_act=True):
    kw = dict(hard_activations=hard, quantize_activations=quant_act)
    return jqat.QATConfig(**kw), tqat.QATConfig(**kw)


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("with_state", [False, True])
def test_qat_lstm_apply_forward(hard, with_state):
    jp, tp = _ref_params("elastic-lstm", seed=6)
    b = _window_batch("elastic-lstm", 64, seed=8)
    jq, tq = _qcfgs(hard)
    st = _quantized_state(9) if with_state else None
    jst = None if st is None else tuple((jnp.asarray(h), jnp.asarray(c))
                                        for h, c in st)
    tst = None if st is None else tuple((torch.from_numpy(h),
                                         torch.from_numpy(c))
                                        for h, c in st)
    jout = jqat.make_qat_lstm_apply(j_get_config("elastic-lstm"), jq)(
        jp, jnp.asarray(b["x"]), jst)
    tout = tqat.make_qat_lstm_apply(get_config("elastic-lstm"), tq)(
        tp, torch.from_numpy(b["x"]), tst)
    _assert_forward(jout, tout)


def test_fake_quant_tree_quantizes_weights_only():
    jp, tp = _ref_params("elastic-conv1d", seed=2)
    want = jqat.fake_quant_tree(jp, jfxp.FxpFormat(6, 3))
    got = tqat.fake_quant_tree(tp, tfxp.FxpFormat(6, 3))
    assert _max_leaf_diff(want, got) == 0.0
    assert torch.equal(got["head_b"], tp["head_b"])


# --------------------------------------------------------------------------- #
# Losses and gradients
# --------------------------------------------------------------------------- #


def _tie_case():
    """Parameters and a batch that put the hard activations on their ties:
    with x_0 = 0 (and h = c = 0) the first step's pre-activations are the
    biases, which sit on ±2.5 (hard_sigmoid) and ±1 (hard_tanh) and make
    c = sig(i) * tanh(g) = 1 (hard_tanh of c at its tie too)."""
    jp, _ = _ref_params("elastic-lstm", seed=11)
    H = get_config("elastic-lstm").lstm.hidden
    b = np.zeros(4 * H, np.float32)
    i, f, g, o = (slice(k * H, (k + 1) * H) for k in range(4))
    b[i] = 2.5                       # sig(i) = 1 at the +2.5 tie
    b[g][::2], b[g][1::2] = 1.0, -1.0   # tanh(g) = ±1 at its ties
    b[f][::2], b[f][1::2] = -2.5, 2.5
    b[o][::3] = 2.5
    b[o][1::3] = -2.5
    jp = jax.tree.map(lambda a: a, jp)
    jp["cells"][0]["b"] = jnp.asarray(b)
    bt = _window_batch("elastic-lstm", 64, seed=12)
    bt["x"][:, 0] = 0.0
    return jp, bt


def _grad_case(kind):
    if kind == "ties":
        jp, bt = _tie_case()
        return jp, to_torch(params_from_jax(jp, get_config("elastic-lstm")),
                            "cpu"), bt
    jp, tp = _ref_params("elastic-lstm", seed=13)
    return jp, tp, _window_batch("elastic-lstm", 64, seed=14)


def _check_loss_and_grads(jloss, tloss, jp, tp, bt, tol=1e-5):
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}
    jl, jg = jax.value_and_grad(lambda p: jloss(p, jb)[0])(jp)
    tl, tg = value_and_grad(lambda p: tloss(p, tb)[0])(tp)
    assert abs(float(jl) - float(tl)) <= tol, (float(jl), float(tl))
    err = _max_leaf_diff(jg, tg)
    assert err <= tol, err
    return jg, tg


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("hard", [True, False])
def test_qat_loss_and_grads(kind, hard):
    jp, tp, bt = _grad_case(kind)
    jq, tq = _qcfgs(hard)
    _check_loss_and_grads(
        jqat.make_qat_loss(j_get_config("elastic-lstm"), jq),
        tqat.make_qat_loss(get_config("elastic-lstm"), tq), jp, tp, bt)


def test_tie_batch_hits_the_ties_and_clamp_would_miss_them(monkeypatch):
    """The tie case has teeth: its first-step gates sit on the ties, and
    the same loss with ``torch.clamp``'s whole gradient at a tie (the port
    before this repair) leaves the reference's gradient by far more than
    the bar."""
    jp, tp, bt = _grad_case("ties")
    acc = tfxp.FxpFormat(16, 8)
    z0 = tfxp.fake_quant(tp["cells"][0]["b"], acc)
    assert {2.5, -2.5, 1.0, -1.0} <= set(z0.tolist())
    jq, tq = _qcfgs(True)
    jloss = jqat.make_qat_loss(j_get_config("elastic-lstm"), jq)
    tloss = tqat.make_qat_loss(get_config("elastic-lstm"), tq)
    jg, _ = _check_loss_and_grads(jloss, tloss, jp, tp, bt)
    monkeypatch.setattr(tqat, "_clip", lambda x, lo, hi: torch.clamp(
        x, lo, hi))
    clamp_loss = tqat.make_qat_loss(get_config("elastic-lstm"), tq)
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}
    _, cg = value_and_grad(lambda p: clamp_loss(p, tb)[0])(tp)
    assert _max_leaf_diff(jg, cg) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_window_float_loss_and_grads(arch, kind):
    if arch == "elastic-lstm":
        jp, tp, bt = _grad_case(kind)
    else:
        jp, tp = _ref_params(arch, seed=15)
        bt = _window_batch(arch, 64, seed=16)
        if kind == "ties":
            # codes on the hard_tanh ties: the first block's taps see
            # x = ±1 through unit weights and zero bias
            jp["blocks"][0]["w"] = jnp.zeros_like(jp["blocks"][0]["w"]) \
                .at[0].set(1.0)
            bt["x"] = np.sign(bt["x"]).astype(np.float32)
            tp = to_torch(params_from_jax(jp, get_config(arch)), "cpu")
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jloss = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH,
                             jtypes.ParallelismConfig(
                                 compute_dtype="float32"), None)
    tloss = tlm.make_loss_fn(tcfg, ttypes.SMOKE_MESH,
                             ttypes.ParallelismConfig())
    _check_loss_and_grads(jloss, tloss, jp, tp, bt)


def test_lm_loss_and_train_step_name_their_slice():
    """The LM training slice (ROADMAP A11) gave the LM families their loss
    and train step; they are held against the reference in
    ``tests/test_torch_lm_train.py``. Here: both build and run."""
    cfg = get_config("yi-9b", smoke=True)
    par = ttypes.ParallelismConfig(compute_dtype="float32")
    st = tlm.Stepper(cfg, ttypes.ShapeConfig("t", "train", 16, 2),
                     ttypes.SMOKE_MESH, par)
    params = st.init(device="cpu")
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
             "targets": torch.ones(2, 16, dtype=torch.int32)}
    loss, metrics = tlm.make_loss_fn(cfg, ttypes.SMOKE_MESH, par)(params,
                                                                  batch)
    assert torch.isfinite(loss) and int(metrics["n_tok"]) == 32
    _, opt, metrics = tlm.make_train_step(
        cfg, ttypes.SMOKE_MESH, par, tadamw.AdamWConfig())(
        params, tadamw.init_opt_state(params), batch)
    assert torch.equal(metrics["loss"], loss.detach())
    assert int(opt["step"]) == 1


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #

OCFG = dict(lr=1e-2, warmup_steps=5, total_steps=20, weight_decay=0.1,
            clip_norm=0.5)


@pytest.mark.parametrize("step", [0, 1, 5, 12, 20, 25])
def test_schedule(step):
    jc, tc = jadamw.AdamWConfig(**OCFG), tadamw.AdamWConfig(**OCFG)
    want = float(jadamw.schedule(jc, jnp.int32(step)))
    got = float(tadamw.schedule(tc, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def test_one_adamw_update_with_clipping():
    rng = np.random.default_rng(21)
    jp, tp = _ref_params("elastic-lstm", seed=21)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 3.0), jp)
    tg = to_torch(params_from_jax(jg, get_config("elastic-lstm")), "cpu")
    jopt = jadamw.init_opt_state(jp)
    topt = tadamw.init_opt_state(tp)
    # a second step, so the moments and bias corrections are not trivial
    jc, tc = jadamw.AdamWConfig(**OCFG), tadamw.AdamWConfig(**OCFG)
    jp1, jopt, jinfo = jadamw.adamw_update(jg, jopt, jp, jc)
    tp1, topt, tinfo = tadamw.adamw_update(tg, topt, tp, tc)
    assert float(jinfo["gnorm"]) > OCFG["clip_norm"]          # clipping on
    for a, b in ((jp1, tp1), (jopt["mu"], topt["mu"]),
                 (jopt["nu"], topt["nu"])):
        assert _max_leaf_diff(a, b) <= 1e-6
    assert abs(float(jinfo["gnorm"]) - float(tinfo["gnorm"])) <= 1e-6 * \
        float(jinfo["gnorm"])
    assert float(jinfo["lr"]) == float(tinfo["lr"])
    assert int(topt["step"]) == int(jopt["step"]) == 1
    assert topt["step"].dtype == torch.int32
    assert float(tadamw.global_norm(tg)) == pytest.approx(
        float(jadamw.global_norm(jg)), rel=1e-6)


def test_twenty_float_adamw_steps_track_the_reference():
    cfg, jcfg = get_config("elastic-lstm"), j_get_config("elastic-lstm")
    shape = ttypes.SHAPES_LSTM["train_batch"]
    jst = jlm.Stepper(jcfg, jtypes.SHAPES_LSTM["train_batch"],
                      jtypes.SMOKE_MESH,
                      jtypes.ParallelismConfig(compute_dtype="float32"),
                      opt_cfg=jadamw.AdamWConfig(**OCFG))
    tst = tlm.Stepper(cfg, shape, ttypes.SMOKE_MESH,
                      ttypes.ParallelismConfig(),
                      opt_cfg=tadamw.AdamWConfig(**OCFG))
    jp, tp = _ref_params("elastic-lstm", seed=22)
    jopt, topt = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jstep, tstep = jax.jit(jst.train_fn()), tst.train_fn()
    worst = 0.0
    for s in range(20):
        b = {k: v for k, v in jdata.traffic_flow_batch(
            jdata.TrafficConfig(batch=64, seed=3), s).items()}
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        worst = max(worst, _max_leaf_diff(jp, tp))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    assert worst <= 1e-5, worst


# --------------------------------------------------------------------------- #
# A short QAT run of the example's lstm_train_fn, lowered to the IR
# --------------------------------------------------------------------------- #

QAT_STEPS = 10
KNOBS = {"bits": 8, "frac": 6}


@pytest.fixture(scope="module")
def short_qat_run():
    ex = _example()
    ex.TRAIN_STEPS = QAT_STEPS
    jparams, jrep, _ = ex.lstm_train_fn(dict(KNOBS))
    # the example's per-step losses, from its own jitted step
    cfg = j_get_config("elastic-lstm")
    jq = jqat.QATConfig(weight_fmt=jfxp.FxpFormat(8, 6),
                        act_fmt=jfxp.FxpFormat(8, 4))
    loss_fn = jqat.make_qat_loss(cfg, jq)
    batch = {k: jnp.asarray(v) for k, v in jdata.traffic_flow_batch(
        jdata.TrafficConfig(batch=256), 0).items()}
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=150,
                              weight_decay=0.0)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(lambda pp: loss_fn(pp, batch)[0])(p)
        p2, o2, _ = jadamw.adamw_update(g, o, p, ocfg)
        return p2, o2, loss

    p0 = jlayers.init_params(jlstm.lstm_schema(cfg), jax.random.PRNGKey(0))
    p, o, jlosses = p0, jadamw.init_opt_state(p0), []
    for _ in range(QAT_STEPS):
        p, o, loss = step(p, o)
        jlosses.append(float(loss))
    assert _max_leaf_diff(p, to_torch(params_from_jax(
        jparams, get_config("elastic-lstm")), "cpu")) == 0.0
    t0 = to_torch(params_from_jax(p0, get_config("elastic-lstm")), "cpu")
    tparams, trep, _ = tew.lstm_train_fn(dict(KNOBS), device="cpu",
                                         steps=QAT_STEPS, params=t0)
    tq = tqat.make_qat_loss(get_config("elastic-lstm"), tew._qat_cfg(KNOBS))
    tb = {k: torch.from_numpy(v) for k, v in tdata.traffic_flow_batch(
        tdata.TrafficConfig(batch=256), 0).items()}
    _, tlosses = tew.train(lambda pp, b: tq(pp, b)[0], t0, tb, QAT_STEPS)
    return jparams, jrep, jlosses, tparams, trep, tlosses.tolist()


def test_short_qat_run_losses_track_the_reference(short_qat_run):
    _, jrep, jlosses, _, trep, tlosses = short_qat_run
    assert len(jlosses) == len(tlosses) == QAT_STEPS
    for s, (a, b) in enumerate(zip(jlosses, tlosses)):
        assert abs(a - b) <= 1e-4, (s, a, b)
    assert abs(jrep.train_loss - trep.train_loss) <= 1e-4
    assert abs(jrep.eval_loss - trep.eval_loss) <= 1e-4
    assert (trep.weight_fmt, trep.act_fmt) == (jrep.weight_fmt,
                                               jrep.act_fmt)


def _near_boundary(w, scale) -> np.ndarray:
    """Where ``w * scale`` lies within 1e-5 LSB of a rounding boundary."""
    v = np.asarray(w, np.float64) * scale
    return np.abs(np.abs(v - np.floor(v)) - 0.5) <= 1e-5


def test_short_qat_run_lowers_to_the_same_design(short_qat_run, capsys):
    jparams, _, _, tparams, _, _ = short_qat_run
    opts = RTL_TARGET.options_from_knobs(KNOBS)
    fmts = dict(w_fmt=opts.w_fmt, act_fmt=opts.act_fmt,
                state_fmt=opts.state_fmt)
    jfmts = {k: jfxp.FxpFormat(f.total_bits, f.frac_bits)
             for k, f in fmts.items()}
    jg = jir.lower_model(j_get_config("elastic-lstm"), jparams, **jfmts)
    tg = tir.lower_model(get_config("elastic-lstm"),
                         tree_map(_np, tparams), **fmts)
    assert tg.iso_key() == jg.iso_key()
    differ, near = 0, 0
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert jn.name == tn.name
        if not hasattr(jn, "weight_int"):
            continue
        in_frac = (jn.act_fmt if jn.op == "lstm_cell" else jn.in_fmt) \
            .frac_bits
        for what, scale in (("weight", 2.0 ** jn.w_fmt.frac_bits),
                            ("bias", 2.0 ** (jn.w_fmt.frac_bits + in_frac))):
            a = np.asarray(getattr(jn, f"{what}_int")(), np.int64)
            b = np.asarray(getattr(tn, f"{what}_int")(), np.int64)
            mask = a != b
            if mask.any():
                boundary = _near_boundary(getattr(jn, what), scale) \
                    | _near_boundary(getattr(tn, what), scale)
                assert not (mask & ~boundary).any(), (jn.name, what)
                assert int(np.abs(a - b).max()) == 1
                near += int((mask & boundary).sum())
            differ += int(mask.sum())
    with capsys.disabled():
        print(f"\nshort QAT run: {differ} lowered integer codes differ from "
              f"the reference's, all within 1e-5 LSB of a rounding boundary "
              f"({near})")


# --------------------------------------------------------------------------- #
# Data pipeline, shape tables, parameter counts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (9, 1), (3, 17)])
def test_data_batches_bit_for_bit(seed, step):
    pairs = [
        (jdata.traffic_flow_batch(jdata.TrafficConfig(batch=32, seed=seed),
                                  step),
         tdata.traffic_flow_batch(tdata.TrafficConfig(batch=32, seed=seed),
                                  step)),
        (jdata.sensor_window_batch(jdata.SensorConfig(batch=32, seed=seed),
                                   step),
         tdata.sensor_window_batch(tdata.SensorConfig(batch=32, seed=seed),
                                   step)),
        (jdata.lm_batch_for_step(jdata.LMDataConfig(
            vocab_size=500, seq_len=24, global_batch=4, seed=seed), step),
         tdata.lm_batch_for_step(tdata.LMDataConfig(
             vocab_size=500, seq_len=24, global_batch=4, seed=seed), step))]
    for want, got in pairs:
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_lm_iterator_and_prefetcher():
    jc = jdata.LMDataConfig(vocab_size=300, seq_len=8, global_batch=2, seed=5)
    tc = tdata.LMDataConfig(vocab_size=300, seq_len=8, global_batch=2, seed=5)
    jit_, tit = jdata.make_lm_iterator(jc, 3), tdata.make_lm_iterator(tc, 3)
    pf = tdata.Prefetcher(tdata.make_lm_iterator(tc, 3), depth=2)
    try:
        for _ in range(4):
            want, got, pre = next(jit_), next(tit), next(pf)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(pre[k], want[k])
    finally:
        pf.close()
    finite = tdata.Prefetcher(iter(range(3)), depth=1)
    assert list(finite) == [0, 1, 2]


def test_shape_tables_and_param_counts():
    for name in ("SHAPES", "SHAPES_LSTM", "SHAPES_CONV1D"):
        want, got = getattr(jtypes, name), getattr(ttypes, name)
        assert {k: (s.name, s.kind, s.seq_len, s.global_batch, s.tokens)
                for k, s in want.items()} == \
            {k: (s.name, s.kind, s.seq_len, s.global_batch, s.tokens)
             for k, s in got.items()}
    for arch, smoke in (("elastic-lstm", False), ("elastic-conv1d", False),
                        ("yi-9b", True), ("stablelm-3b", True)):
        jc, tc = j_get_config(arch, smoke=smoke), get_config(arch,
                                                             smoke=smoke)
        assert tuple(jtypes.shape_table_for(jc)) == \
            tuple(ttypes.shape_table_for(tc))
        assert jtypes.shapes_for(jc) == ttypes.shapes_for(tc)
        assert jtypes.skipped_shapes_for(jc) == ttypes.skipped_shapes_for(tc)
        assert jc.active_param_count() == tc.active_param_count()
        for shape in ttypes.shape_table_for(tc).values():
            js = jtypes.shape_table_for(jc)[shape.name]
            assert ttarget.model_flops_estimate(tc, shape) == \
                jlm_model_flops(jc, js)


def jlm_model_flops(cfg, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core.target import model_flops_estimate
    return model_flops_estimate(cfg, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_schema_covers_the_window_families(arch):
    jsch = jlm.param_schema(j_get_config(arch))
    tsch = ttf.param_schema(get_config(arch))
    js = [tuple(s.shape) for s in jax.tree.leaves(
        jsch, is_leaf=jlayers.is_pspec)]
    ts = [tuple(s.shape) for s in tree_leaves(
        tsch, is_leaf=lambda s: hasattr(s, "init"))]
    assert js == ts
    specs = tlm.input_specs(get_config(arch),
                            ttypes.shape_table_for(get_config(arch))
                            ["train_batch"])
    jspecs = jlm.input_specs(j_get_config(arch),
                             jtypes.shape_table_for(j_get_config(arch))
                             ["train_batch"])
    assert {k: v[0] for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}


def test_window_prefill_step_is_one_window_inference():
    jp, tp = _ref_params("elastic-lstm", seed=30)
    x = _window_batch("elastic-lstm", 3, seed=31)["x"]
    jstep = jlm.make_prefill_step(j_get_config("elastic-lstm"),
                                  jtypes.SMOKE_MESH,
                                  jtypes.ParallelismConfig())
    tstep = tlm.make_prefill_step(get_config("elastic-lstm"),
                                  ttypes.SMOKE_MESH,
                                  ttypes.ParallelismConfig())
    _assert_forward(jstep(jp, {"x": jnp.asarray(x)}),
                    tstep(tp, {"x": torch.from_numpy(x)}))
    assert math.isfinite(float(tstep(tp, {"x": torch.from_numpy(x)})[0]
                               .sum()))
