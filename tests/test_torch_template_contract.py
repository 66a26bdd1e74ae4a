"""PyTorch port, the template execution contract (ROADMAP §C6): a template
written to the reference's ``HWTemplate.execute`` contract runs on the
port. The reference hands a template ``em.interpret`` (its Pallas flag)
and its own templates pass it to ``mac_int(..., interpret=)``; B1's
wrapper takes the reference's ``block_b``. The port accepts both and reads
neither: a tensor's device picks the kernel or its plain version.

Each custom template below is the reference's ``LinearTemplate.execute``
(``repro/rtl/oplib.py:353``) in each package's tensor type, registered in
both packages under one new kind; the emulators' codes must be equal,
integer for integer, in every mode. All on the CPU.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp

    from repro.kernels.lstm_cell_int import lstm_window_int as j_lstm
    from repro.kernels.lstm_cell_int.kernel import CellSpec as JCellSpec
    from repro.quant.fixedpoint import FxpFormat as JF
    from repro.rtl import oplib as joplib
    from repro.rtl.emulator import RTLEmulator as JRTLEmulator
    from repro.verify import vectors as jvec

from repro_torch.kernels.lstm_cell_int import CellSpec, lstm_window_int
from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl import oplib as toplib
from repro_torch.rtl.emulator import RTLEmulator
from repro_torch.verify import vectors as tvec

KIND = "contract_linear_test"
MODES = ("fused", "pallas", "jnp")
T = types.SimpleNamespace(oplib=toplib, vec=tvec,
                          int32=lambda a: a.to(torch.int32))
J = types.SimpleNamespace(oplib=joplib, vec=jvec,
                          int32=lambda a: a.astype(jnp.int32))


def _reference_style_template(pkg):
    """The reference's LinearTemplate.execute, verbatim but for the int32
    cast, as a custom template of ``pkg``."""

    class ContractLinear(pkg.oplib.LinearTemplate):
        kind = KIND

        def execute(self, n, env, em, mode):
            x = pkg.int32(env[n.inputs[0]])
            x = x.reshape(x.shape[0], -1)        # serial MACs read linearly
            p = em.prepared(n.name)
            shift = pkg.oplib.requant_shift(n.in_fmt, n.w_fmt, n.out_fmt)
            env[n.outputs[0]] = pkg.oplib.mac_int(
                x, p["w"], p["b"], shift=shift, fmt=n.out_fmt, mode=mode,
                interpret=em.interpret)

    return ContractLinear()


def _graph_with_custom_head(pkg):
    """Table I's canonical design with its linear head served by the
    custom template."""
    g = pkg.vec.canonical_graph("elastic-lstm")[0]
    g.nodes = [dataclasses.replace(n, op=KIND) if n.op == "linear" else n
               for n in g.nodes]
    return g


@pytest.mark.parametrize("mode", MODES)
def test_reference_style_template_runs_in_both_packages(mode):
    x = np.random.default_rng(26).integers(-128, 128, (37, 6, 1)) \
        .astype(np.int32)
    outs = {}
    for name, pkg in (("port", T), ("ref", J)):
        pkg.oplib.register_template(_reference_style_template(pkg))
        try:
            g = _graph_with_custom_head(pkg)
            if pkg is T:
                em = RTLEmulator(g, mode=mode, device="cpu")
            else:
                em = JRTLEmulator(g, mode=mode)
            assert em.interpret is True          # not on the accelerator
            outs[name] = np.asarray(em.run_int(x).outputs)
        finally:
            pkg.oplib.unregister_template(KIND)
    np.testing.assert_array_equal(outs["port"], outs["ref"])
    # the built-in linear template gives the same codes
    plain = RTLEmulator(tvec.canonical_graph("elastic-lstm")[0], mode=mode,
                        device="cpu").run_int(x).outputs.numpy()
    np.testing.assert_array_equal(outs["port"], plain)
    assert KIND not in toplib.list_templates()


def test_emulator_interpret_is_not_on_the_card():
    em = RTLEmulator(tvec.canonical_graph("elastic-lstm")[0], device="cpu")
    assert em.interpret is True
    assert em.interpret == JRTLEmulator(
        jvec.canonical_graph("elastic-lstm")[0]).interpret
    # the program walk's view of the emulator carries it as well
    from repro_torch.rtl.emulator import _ExecCtx

    assert _ExecCtx(em, em.params()).interpret is True


@pytest.mark.parametrize("interpret", [True, False])
def test_mac_int_takes_interpret_and_ignores_it(interpret):
    """ROADMAP §C6's smallest input: x = arange(12) (3, 4), w = ones (4, 2),
    b = 0, shift 1, Q8.4, mode "pallas"."""
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    w = np.ones((4, 2), np.int32)
    b = np.zeros(2, np.int32)
    want = np.asarray(joplib.mac_int(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), shift=1,
        fmt=JF(8, 4), mode="pallas", interpret=True))
    np.testing.assert_array_equal(want, [[3, 3], [11, 11], [19, 19]])
    args = tuple(torch.from_numpy(a) for a in (x, w, b))
    for mode in ("pallas", "fused", "jnp"):
        got = toplib.mac_int(*args, shift=1, fmt=FxpFormat(8, 4), mode=mode,
                             interpret=interpret)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(toplib.mac_int(
        *args, shift=1, fmt=FxpFormat(8, 4), mode="pallas").numpy(), want)


def _table_i_cell():
    rng = np.random.default_rng(6)
    S, din, hid = 6, 1, 20
    lo, hi = -128, 127
    arrays = tuple(np.asarray(a, np.int32) for a in (
        rng.integers(lo, hi + 1, (70, S, din)),
        rng.integers(lo, hi + 1, (din + hid, 4 * hid)),
        rng.integers(-1024, 1024, (4 * hid,)),
        rng.integers(lo, hi + 1, 256), rng.integers(lo, hi + 1, 256)))
    spec = CellSpec(seq_len=S, d_in=din, hidden=hid,
                    act_fmt=FxpFormat(8, 4), state_fmt=FxpFormat(16, 8),
                    w_fmt=FxpFormat(8, 6), sig_lo=lo, tanh_lo=lo)
    jspec = JCellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=JF(8, 4),
                      state_fmt=JF(16, 8), w_fmt=JF(8, 6), sig_lo=lo,
                      tanh_lo=lo)
    return arrays, spec, jspec


@pytest.mark.parametrize("block_b", [1, 64, 128, 1000])
def test_b1_wrapper_takes_block_b_and_ignores_it(block_b):
    """ROADMAP §C6's smallest input: B1's wrapper with block_b on Table
    I's cell gives the reference's codes, and the codes of a call
    without it."""
    arrays, spec, jspec = _table_i_cell()
    want = np.asarray(j_lstm(*(jnp.asarray(a) for a in arrays), spec=jspec,
                             block_b=block_b))
    args = tuple(torch.from_numpy(a) for a in arrays)
    before = lstm_ops.launches
    got = lstm_window_int(*args, spec=spec, block_b=block_b)
    assert lstm_ops.launches == before              # the CPU: no kernel
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), lstm_window_int(*args, spec=spec).numpy())


@pytest.mark.parametrize("bad", [0, -3, 2.0, "64", True])
def test_b1_wrapper_refuses_a_block_b_that_is_not_a_positive_int(bad):
    arrays, spec, _ = _table_i_cell()
    with pytest.raises(ValueError, match="block_b"):
        lstm_window_int(*(torch.from_numpy(a) for a in arrays), spec=spec,
                        block_b=bad)
