"""PyTorch port, fixed-point core: requant, integer codes and activation ROM
tables against the JAX reference, exact integer equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                       # image lacks hypothesis: use shim
    from _hypothesis_compat import given, settings, st

from repro.quant import fixedpoint as jfx
from repro.rtl.ir import ActLUTNode as JActLUTNode
from repro_torch.quant import fixedpoint as tfx
from repro_torch.quant.qat import hard_sigmoid, hard_tanh
from repro_torch.rtl.ir import ActLUTNode as TActLUTNode


def _both(total, frac):
    return jfx.FxpFormat(total, frac), tfx.FxpFormat(total, frac)


def _requant_pair(v: np.ndarray, from_frac: int, total: int, frac: int):
    jf, tf = _both(total, frac)
    want = np.asarray(jfx.fxp_requant_int(jnp.asarray(v), from_frac, jf))
    got = tfx.fxp_requant_int(torch.from_numpy(v), from_frac, tf).numpy()
    return got, want


@pytest.mark.parametrize("shift", [-3, 0, 1, 2, 6, 12])
@pytest.mark.parametrize("total,frac", [(8, 4), (16, 8), (32, 0)])
def test_requant_matches_jax(shift, total, frac):
    """Positive (round-half-even right), zero and negative (left) shifts,
    with exact .5 ties on both parities of the quotient pinned."""
    rng = np.random.default_rng(shift + 17 * total)
    v = rng.integers(-(1 << 20), 1 << 20, 512).astype(np.int32)
    if shift > 0:
        half = 1 << (shift - 1)
        q = np.arange(-9, 10, dtype=np.int32)
        v = np.concatenate([v, (q << shift) + half, (q << shift) - half,
                            q << shift])
    got, want = _requant_pair(v, frac + shift, total, frac)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_requant_ties_round_to_even():
    """2.5 -> 2, 3.5 -> 4, -2.5 -> -2 at one fractional bit."""
    v = np.array([5, 7, -5, -7, 3, -3], np.int32)
    got, want = _requant_pair(v, 1, 16, 0)
    np.testing.assert_array_equal(got, [2, 4, -2, -4, 2, -2])
    np.testing.assert_array_equal(got, want)


@given(st.integers(-(1 << 23), (1 << 23) - 1), st.integers(-4, 14),
       st.integers(4, 16))
@settings(max_examples=200, deadline=None)
def test_requant_property(val, shift, total):
    frac = min(4, total - 1)
    v = np.array([val, -val, val // 2], np.int32)
    got, want = _requant_pair(v, frac + shift, total, frac)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total,frac,dtype", [
    (4, 2, np.int8), (8, 4, np.int8), (8, 6, np.int8), (12, 6, np.int16),
    (16, 8, np.int16), (32, 10, np.int32)])
def test_fxp_to_int_values_and_dtypes(total, frac, dtype):
    jf, tf = _both(total, frac)
    rng = np.random.default_rng(total * 31 + frac)
    x = (rng.standard_normal(400) * 4).astype(np.float32)
    x = np.concatenate([x, np.array([0.5, 1.5, -0.5, -2.5, 1e6, -1e6],
                                    np.float32) / jf.scale])
    want = np.asarray(jfx.fxp_to_int(jnp.asarray(x), jf))
    got = tfx.fxp_to_int(x, tf).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfx.fxp_quantize(x, tf).numpy(),
        np.asarray(jfx.fxp_quantize(jnp.asarray(x), jf)))


@pytest.mark.parametrize("kind", ["hard_sigmoid", "hard_tanh"])
@pytest.mark.parametrize("in_f,out_f", [((8, 4), (8, 4)), ((8, 6), (8, 6)),
                                        ((6, 3), (8, 5)), ((10, 5), (8, 4)),
                                        ((12, 8), (16, 8))])
def test_rom_tables_match_reference(kind, in_f, out_f):
    """The torch hard activations generate ROM tables identical to the
    reference's ActLUTNode.table() for every format the tests use."""
    kw = dict(name="lut", op="act_lut", inputs=[], outputs=[], kind=kind)
    want = JActLUTNode(in_fmt=jfx.FxpFormat(*in_f),
                       out_fmt=jfx.FxpFormat(*out_f), **kw).table()
    got = TActLUTNode(in_fmt=tfx.FxpFormat(*in_f),
                      out_fmt=tfx.FxpFormat(*out_f), **kw).table()
    assert got.dtype == np.int32 and got.shape == (2 ** in_f[0],)
    np.testing.assert_array_equal(got, want)


def test_hard_activations_match_reference():
    from repro.quant import qat as jqat

    x = np.linspace(-4, 4, 1025, dtype=np.float32)
    for t_fn, j_fn in ((hard_sigmoid, jqat.hard_sigmoid),
                       (hard_tanh, jqat.hard_tanh)):
        np.testing.assert_array_equal(
            t_fn(torch.from_numpy(x)).numpy(), np.asarray(j_fn(jnp.asarray(x))))
