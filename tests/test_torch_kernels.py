"""PyTorch port, kernels B1 (fused int LSTM window) and B2 (int MAC): the
plain versions against the JAX reference kernels, exact integer equality,
and B1's routing between its two CUDA variants. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell_int import CellSpec as JCellSpec
from repro.kernels.lstm_cell_int import lstm_window_int as j_lstm_window_int
from repro.kernels.lstm_cell_int import (
    lstm_window_int_ref as j_lstm_window_int_ref)
from repro.quant.fixedpoint import FxpFormat as JF
from repro.rtl.oplib import _mac_int_jnp, mac_int_pallas
from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_int_cuda,
                                               lstm_window_int_ref, variant)
from repro_torch.kernels.lstm_cell_int import kernel as kernel_mod
from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.kernels.mac_int import ops as mac_ops
from repro_torch.quant.fixedpoint import FxpFormat

LSTM_SHAPES = [(1, 6, 1, 20), (7, 6, 3, 16), (64, 4, 2, 8), (200, 6, 1, 20)]
# every MAC call shape of the main path (rows, K, N), at a small batch:
# LSTM head, conv1d im2col frames of both blocks, conv head, per-step gate
MAC_SHAPES = [(7, 20, 1), (7 * 7, 9, 3), (7 * 3, 9, 3), (7, 9, 1),
              (7, 21, 80)]
MAC_SHIFTS = [-2, 0, 2, 6]


def _lstm_case(shape):
    """The inputs of tests/test_kernels.py::test_lstm_window_int: random
    codes, weights, biases and in-range random ROMs (exercises the
    gathers, not the activations)."""
    B, S, din, hid = shape
    rng = np.random.default_rng(B + S)
    A, W = (8, 4), (8, 6)
    lo, hi = -(1 << 7), (1 << 7) - 1
    arrays = (rng.integers(lo, hi + 1, (B, S, din)),
              rng.integers(lo, hi + 1, (din + hid, 4 * hid)),
              rng.integers(-(1 << 10), 1 << 10, (4 * hid,)),
              rng.integers(lo, hi + 1, 256), rng.integers(lo, hi + 1, 256))
    arrays = tuple(np.asarray(a, np.int32) for a in arrays)
    jspec = JCellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=JF(*A),
                      state_fmt=JF(16, 8), w_fmt=JF(*W), sig_lo=lo,
                      tanh_lo=lo)
    tspec = CellSpec(seq_len=S, d_in=din, hidden=hid,
                     act_fmt=FxpFormat(*A), state_fmt=FxpFormat(16, 8),
                     w_fmt=FxpFormat(*W), sig_lo=lo, tanh_lo=lo)
    return arrays, jspec, tspec


@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_window_plain_matches_reference(shape):
    arrays, jspec, tspec = _lstm_case(shape)
    want = np.asarray(j_lstm_window_int_ref(
        *(jnp.asarray(a) for a in arrays), spec=jspec))
    got = lstm_window_int_ref(*(torch.from_numpy(a) for a in arrays),
                              spec=tspec)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if shape == LSTM_SHAPES[-1]:         # the Pallas kernel, interpreted
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            j_lstm_window_int(*(jnp.asarray(a) for a in arrays),
                              spec=jspec)))


def test_lstm_window_wrapper_on_cpu_runs_plain_version():
    arrays, _, tspec = _lstm_case(LSTM_SHAPES[1])
    args = tuple(torch.from_numpy(a) for a in arrays)
    before = lstm_ops.launches
    got = lstm_window_int(*args, spec=tspec)
    assert lstm_ops.launches == before           # no kernel on the CPU
    assert torch.equal(got, lstm_window_int_ref(*args, spec=tspec))


def test_lstm_window_wrapper_checks_arguments():
    arrays, _, tspec = _lstm_case(LSTM_SHAPES[0])
    x, w, b, sig, tanh = (torch.from_numpy(a) for a in arrays)
    with pytest.raises(ValueError, match="int32"):
        lstm_window_int(x.to(torch.int64), w, b, sig, tanh, spec=tspec)
    with pytest.raises(ValueError, match="shape"):
        lstm_window_int(x, w[:-1], b, sig, tanh, spec=tspec)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_window_int(x, w.t().contiguous().t(), b, sig, tanh, spec=tspec)
    with pytest.raises(ValueError, match="ROM"):
        lstm_window_int(x, w, b, sig[:100], tanh, spec=tspec)


def _spec(act=(8, 4), w=(8, 6), d_in=1, hidden=20):
    A = FxpFormat(*act)
    return CellSpec(seq_len=6, d_in=d_in, hidden=hidden, act_fmt=A,
                    state_fmt=FxpFormat(16, 8), w_fmt=FxpFormat(*w),
                    sig_lo=A.lo, tanh_lo=A.lo)


@pytest.mark.parametrize("w_bits", [2, 4, 6, 8])
@pytest.mark.parametrize("act_bits", [2, 4, 6, 8])
def test_lstm_variant_routes_8bit_cells_to_mma(act_bits, w_bits):
    """Table I (Q8.4 codes, Q8.6 weights, hidden 20, d_in 1) and every cell
    whose codes fit int8, up to the mma kernel's K and hidden limits."""
    act, w = (act_bits, act_bits // 2), (w_bits, w_bits - 1)
    assert variant(_spec(act, w)) == "mma"
    assert variant(_spec(act, w, d_in=64, hidden=64)) == "mma"
    assert variant(_spec(act, w, d_in=20, hidden=8)) == "mma"


@pytest.mark.parametrize("act,w,d_in,hidden", [
    ((9, 4), (8, 6), 1, 20), ((12, 6), (8, 6), 1, 20),
    ((16, 8), (8, 6), 1, 20), ((8, 4), (9, 6), 1, 20),
    ((8, 4), (12, 8), 1, 20), ((8, 4), (8, 6), 1, 65),
    ((8, 4), (8, 6), 65, 64), ((8, 4), (8, 6), 100, 29)])
def test_lstm_variant_routes_the_rest_to_simt(act, w, d_in, hidden):
    """9+-bit act or weight codes, or a cell outside the mma kernel's
    exactness envelope (K = d_in + hidden > 128, hidden > 64)."""
    assert variant(_spec(act, w, d_in, hidden)) == "simt"


def test_lstm_cuda_launcher_refuses_what_its_variant_cannot_take():
    """Refused before any library is loaded, so also without a card."""
    arrays, _, tspec = _lstm_case(LSTM_SHAPES[0])
    args = tuple(torch.from_numpy(a) for a in arrays)
    out = torch.empty((1, 6, 20), dtype=torch.int32)
    wide = _spec(act=(12, 6))
    with pytest.raises(ValueError, match="mma kernel does not take"):
        lstm_window_int_cuda(*args, out, spec=wide, variant="mma")
    with pytest.raises(ValueError, match="unknown variant"):
        lstm_window_int_cuda(*args, out, spec=tspec, variant="wgmma")
    before = dict(lstm_ops.launches_by_variant)
    lstm_window_int(*args, spec=tspec)            # CPU: the plain version
    assert lstm_ops.launches_by_variant == before


@pytest.mark.parametrize("w_fmt,code", [((8, 6), 128), ((8, 6), -129),
                                         ((6, 4), 32), ((6, 4), -33)])
def test_lstm_mma_launcher_refuses_w_outside_its_format(w_fmt, code):
    """A W code outside w_fmt would not fit the mma kernel's int8
    fragments: the check says so, also after the same tensor passed once
    and was then written in place, the wrapper's routing sends such a W to
    simt, and the mma launcher refuses it with a ValueError before any
    library is loaded."""
    arrays, _, _ = _lstm_case(LSTM_SHAPES[0])
    spec = _spec(w=w_fmt)
    fmt = spec.w_fmt
    x, w, b, sig, tanh = (torch.from_numpy(a) for a in arrays)
    w = w.clamp(fmt.lo, fmt.hi)
    out = torch.empty((1, 6, 20), dtype=torch.int32)
    assert kernel_mod.check_w_codes(w, spec)          # in range
    assert variant(spec, w) == "mma"
    w[3, 7] = code
    assert not kernel_mod.check_w_codes(w, spec)
    assert variant(spec, w) == "simt"
    with pytest.raises(ValueError, match="outside"):
        lstm_window_int_cuda(x, w, b, sig, tanh, out, spec=spec,
                             variant="mma")


def _mac_case(rows, K, N, shift):
    rng = np.random.default_rng(rows * 100 + K * 10 + N + shift)
    xh = rng.integers(-128, 128, (rows, K)).astype(np.int32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int32)
    b = rng.integers(-(1 << 10), 1 << 10, N).astype(np.int32)
    fmt = (16, 8) if shift <= 2 else (8, 4)
    return (xh, w, b), fmt


@pytest.mark.parametrize("shift", MAC_SHIFTS)
@pytest.mark.parametrize("rows,K,N", MAC_SHAPES)
def test_mac_plain_matches_reference(rows, K, N, shift):
    (xh, w, b), fmt = _mac_case(rows, K, N, shift)
    jfmt = JF(*fmt)
    kw = dict(shift=shift, lo=jfmt.lo, hi=jfmt.hi)
    want = np.asarray(_mac_int_jnp(jnp.asarray(xh), jnp.asarray(w),
                                   jnp.asarray(b), **kw))
    got = mac_int_ref(torch.from_numpy(xh), torch.from_numpy(w),
                      torch.from_numpy(b), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if shift == MAC_SHIFTS[-1]:          # the Pallas kernel, interpreted
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(mac_int_pallas(
                jnp.asarray(xh), jnp.asarray(w), jnp.asarray(b), **kw)))


def test_mac_plain_wraps_like_int32_dot():
    """Accumulators past int32 wrap two's-complement, like dot_general with
    preferred_element_type=int32 (outside the §4 envelope on purpose)."""
    xh = np.full((3, 4), 2 ** 30 - 1, np.int32)
    xh[1] *= -1
    w = np.full((4, 2), 7, np.int32)
    b = np.array([2 ** 31 - 1, -(2 ** 31)], np.int32)
    kw = dict(shift=0, lo=-(2 ** 31), hi=2 ** 31 - 1)
    want = np.asarray(_mac_int_jnp(jnp.asarray(xh), jnp.asarray(w),
                                   jnp.asarray(b), **kw))
    got = mac_int_ref(torch.from_numpy(xh), torch.from_numpy(w),
                      torch.from_numpy(b), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mac_wrapper_on_cpu_and_argument_checks():
    (xh, w, b), fmt = _mac_case(7, 21, 80, 6)
    f = FxpFormat(*fmt)
    args = tuple(torch.from_numpy(a) for a in (xh, w, b))
    before = mac_ops.launches
    got = mac_int_op(*args, shift=6, lo=f.lo, hi=f.hi)
    assert mac_ops.launches == before
    assert torch.equal(got, mac_int_ref(*args, shift=6, lo=f.lo, hi=f.hi))
    with pytest.raises(ValueError, match="shift"):
        mac_int_op(*args, shift=32, lo=f.lo, hi=f.hi)
    with pytest.raises(ValueError, match="chain"):
        mac_int_op(args[0][:, :-1].contiguous(), args[1], args[2], shift=6,
                   lo=f.lo, hi=f.hi)
    with pytest.raises(ValueError, match="contiguous"):
        mac_int_op(args[0][:, :-1], args[1][:-1], args[2], shift=6,
                   lo=f.lo, hi=f.hi)
    with pytest.raises(ValueError, match="int32"):
        mac_int_op(args[0].float(), args[1], args[2], shift=6, lo=f.lo,
                   hi=f.hi)
