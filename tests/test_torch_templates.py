"""PyTorch port, the wrapper-only templates B3 (float LSTM window), B4 (int8
matmul), B6 (Mamba-2 SSD) and B7 (RWKV-6 WKV): each port wrapper on the CPU
(its plain version) against the JAX wrapper (Pallas in interpret mode, as
tests/test_kernels.py runs it) and the JAX oracle, at the reference test's
shapes and tolerances, with the same inputs made from a numpy seed; the
oracles of model/{lstm,ssm,rwkv}.py step by step; and the contracts the
wrappers keep (bad shapes raise, no launch on the CPU, no other device).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.ops import lstm_window as j_lstm_window
from repro.kernels.lstm_cell.ref import lstm_window_ref as j_lstm_window_ref
from repro.kernels.mamba2.ops import ssd as j_ssd
from repro.kernels.quant_matmul.ops import quant_matmul as j_quant_matmul
from repro.kernels.quant_matmul.ref import quant_matmul_ref as j_qmm_ref
from repro.kernels.quant_matmul.ref import quantize_act as j_quantize_act
from repro.kernels.rwkv6.ops import wkv6 as j_wkv6
from repro.model.lstm import lstm_cell_step as j_lstm_cell_step
from repro.model.rwkv import wkv6_reference as j_wkv6_reference
from repro.model.rwkv import wkv6_step as j_wkv6_step
from repro.model.ssm import ssd_reference as j_ssd_reference
from repro.model.ssm import ssd_step as j_ssd_step
from repro.quant.ptq import quantize_params_int8 as j_quantize_params_int8
from repro_torch.kernels.lstm_cell import lstm_window, lstm_window_cuda
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ssd
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.quant_matmul import (quant_matmul, quant_matmul_ref,
                                              quantize_act)
from repro_torch.kernels.quant_matmul.kernel import tma_readable
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.model.lstm import lstm_cell_step
from repro_torch.model.rwkv import wkv6_reference, wkv6_step
from repro_torch.model.ssm import ssd_reference, ssd_step
from repro_torch.quant.ptq import quantize_params_int8

# the reference test's bars (tests/test_kernels.py:88, :35, :165-166,
# :147-148)
LSTM_TOL = 1e-5
QMM_TOL = 1e-3
SSD_TOL = 1e-4
WKV_TOL = 1e-4


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32))
                 .max())


# ---- B3 ---------------------------------------------------------------------
def _lstm_case(shape):
    """tests/test_kernels.py::test_lstm_window's distributions."""
    B, S, din, hid = shape
    rng = np.random.default_rng(sum(shape))
    return (_f32(rng, (B, S, din)), _f32(rng, (din + hid, 4 * hid), 0.3),
            _f32(rng, (4 * hid,), 0.1))


# the reference's shapes (test_kernels.py:78); 200 is a ragged batch for
# block_b 128, which the reference pads and the port masks
@pytest.mark.parametrize("shape", [(64, 6, 1, 20), (128, 6, 1, 20),
                                   (32, 12, 4, 32), (200, 6, 1, 20)])
def test_lstm_window_matches_reference_wrapper_and_oracle(shape):
    x, w, b = _lstm_case(shape)
    before = lstm_ops.launches
    got = lstm_window(*map(torch.from_numpy, (x, w, b)), block_b=128)
    assert lstm_ops.launches == before                # CPU: no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0],
                                                               shape[3])
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    for want in (j_lstm_window(jx, jw, jb, block_b=128),
                 j_lstm_window_ref(jx, jw, jb)):
        assert _err(got, want) < LSTM_TOL


def test_lstm_cell_step_matches_reference():
    rng = np.random.default_rng(5)
    w, b = _f32(rng, (36, 128), 0.3), _f32(rng, (128,), 0.1)
    x, h, c = _f32(rng, (9, 4)), _f32(rng, (9, 32)), _f32(rng, (9, 32))
    got = lstm_cell_step(*map(torch.from_numpy, (w, b, x, h, c)))
    want = j_lstm_cell_step(*map(jnp.asarray, (w, b, x, h, c)))
    for g, r in zip(got, want):
        assert _err(g, r) < 1e-6


# B3's routing between its two CUDA kernels, decided from shapes alone;
# (d_in, H): mma takes H <= 64 and d_in + H <= 128
@pytest.mark.parametrize("din,hid,want", [
    (1, 20, "mma"), (4, 32, "mma"), (0, 20, "mma"), (64, 64, "mma"),
    (1, 64, "mma"), (100, 28, "mma"), (65, 64, "simt"), (1, 65, "simt"),
    (3, 100, "simt"), (100, 128, "simt"), (101, 28, "simt")])
def test_lstm_float_variant_routes_by_shape(din, hid, want):
    x, w = torch.zeros(2, 6, din), torch.zeros(din + hid, 4 * hid)
    assert lstm_ops.variant(x, w) == want


def test_lstm_float_counts_no_launch_on_the_cpu():
    x, w, b = map(torch.from_numpy, _lstm_case((20, 6, 1, 20)))
    assert lstm_ops.variant(x, w) == "mma"
    before = (lstm_ops.launches, dict(lstm_ops.launches_by_variant))
    lstm_window(x, w, b)
    assert (lstm_ops.launches, lstm_ops.launches_by_variant) == before


def test_lstm_window_cuda_refuses_what_its_variant_cannot_take():
    """Raised before any kernel is loaded: no fallback to the other
    variant."""
    x, w, b = map(torch.from_numpy, _lstm_case((4, 6, 1, 65)))
    out = torch.empty(4, 65)
    with pytest.raises(ValueError, match="mma kernel does not take"):
        lstm_window_cuda(x, w, b, out, block_b=128, variant="mma")
    with pytest.raises(ValueError, match="unknown variant"):
        lstm_window_cuda(x, w, b, out, block_b=128, variant="wgmma")


# ---- B4 ---------------------------------------------------------------------
def _qmm_case(mkn, dtype):
    """tests/test_kernels.py::test_quant_matmul's distributions; x in
    ``dtype`` on both sides (the same bf16 rounding of the same f32)."""
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N)
    x, w = _f32(rng, (M, K)), _f32(rng, (K, N))
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    return tx, jx, w


@pytest.mark.parametrize("mkn", [(128, 128, 128), (64, 200, 96),
                                 (256, 512, 384), (32, 96, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_matches_reference_wrapper(mkn, dtype):
    tx, jx, w = _qmm_case(mkn, dtype)
    jip = j_quantize_params_int8({"w": jnp.asarray(w)})
    ip = quantize_params_int8({"w": torch.from_numpy(w)})
    # the activation codes and scale are the reference's exactly
    xq, xs = quantize_act(tx)
    jxq, jxs = j_quantize_act(jx)
    assert xq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert xs.item() == float(jxs)
    before = qmm_ops.launches
    got = quant_matmul(tx, ip.q["w"], ip.scale["w"])
    assert qmm_ops.launches == before
    want = j_quant_matmul(jx, jip.q["w"], jip.scale["w"])
    assert got.dtype == torch.float32
    assert _err(got, want) < QMM_TOL
    assert _err(got, j_qmm_ref(jxq, jip.q["w"], jxs, jip.scale["w"])) \
        < QMM_TOL
    # the reference's own accuracy check against the float product
    ref = tx.float() @ torch.from_numpy(w)
    assert ((got - ref).norm() / ref.norm()).item() < 0.03


def test_quant_matmul_use_ref_and_plain_version_agree_exactly():
    tx, _, w = _qmm_case((33, 70, 19), torch.float32)
    ip = quantize_params_int8({"w": torch.from_numpy(w)})
    got = quant_matmul(tx, ip.q["w"], ip.scale["w"], use_ref=True)
    xq, xs = quantize_act(tx)
    assert torch.equal(got, quant_matmul_ref(xq, ip.q["w"], xs,
                                             ip.scale["w"]))
    assert torch.equal(got, quant_matmul(tx, ip.q["w"], ip.scale["w"],
                                         block_m=8, block_n=16, block_k=32))


@pytest.mark.parametrize("mkn", [(4, 64, 48), (20, 144, 264), (3, 200, 96),
                                 (70, 30, 64)])
def test_quant_matmul_on_k_major_codes_matches_reference_wrapper(mkn):
    """The codes as ``quant/ptq.py`` stores them (K-major), at K % 16 == 0
    (what sm90 and gemv read) and not (what the wrapper pads first): the
    JAX wrapper's result within its bar, and the row-major copy's bit for
    bit."""
    tx, jx, w = _qmm_case(mkn, torch.float32)
    ip = quantize_params_int8({"w": torch.from_numpy(w)})
    wq = ip.q["w"]
    assert wq.stride() == (1, mkn[1])
    got = quant_matmul(tx, wq, ip.scale["w"])
    jip = j_quantize_params_int8({"w": jnp.asarray(w)})
    assert _err(got, j_quant_matmul(jx, jip.q["w"], jip.scale["w"])) < QMM_TOL
    assert torch.equal(got, quant_matmul(tx, wq.contiguous(), ip.scale["w"]))


def test_quantize_act_rounds_half_to_even_like_the_reference():
    # amax 127 -> scale exactly 1.0, so x / scale keeps the .5 ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                 np.float32)
    q, s = quantize_act(torch.from_numpy(x))
    jq, js = j_quantize_act(jnp.asarray(x))
    assert s.item() == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]


# ---- B4's routing between its two kernels, and the copy both read -------
def _codes(M, K, N, *, k_major=True):
    """xq (M, K) row-major and wq (K, N) int8 codes, K-major or row-major."""
    xq = torch.ones(M, K, dtype=torch.int8)
    wq = torch.ones(N, K, dtype=torch.int8).T if k_major else \
        torch.ones(K, N, dtype=torch.int8)
    return xq, wq


def _shifted(t, offset):
    """A copy of ``t`` whose storage starts ``offset`` bytes past a 16-byte
    boundary, with the same strides."""
    buf = torch.zeros(t.untyped_storage().nbytes() + 32, dtype=torch.int8)
    start = (-buf.data_ptr()) % 16 + offset
    out = buf[start:start + t.untyped_storage().nbytes()].as_strided(
        t.shape, t.stride())
    out.copy_(t)
    return out


def _random_codes(xq, wq, seed):
    """The same layouts as ``xq`` and ``wq``, filled with random codes."""
    gen = torch.Generator().manual_seed(seed)
    for t in (xq, wq):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                              dtype=torch.int8))
    return xq, wq


def _copies_exactly(xq, wq):
    """``ops.tma_codes`` hands the kernels codes they can read, whose
    product is bit for bit that of ``xq`` and ``wq``."""
    xs, ws = torch.tensor([0.0123]), torch.linspace(0.5, 2.0, wq.shape[1])
    cx, cw = qmm_ops.tma_codes(xq, wq)
    assert tma_readable(cx, cw)
    assert cx.shape[0] == xq.shape[0] and cw.shape[1] == wq.shape[1]
    assert cx.shape[1] == cw.shape[0] and cx.shape[1] % 16 == 0
    assert torch.equal(quant_matmul_ref(cx, cw, xs, ws),
                       quant_matmul_ref(xq, wq, xs, ws))
    return cx, cw


@pytest.mark.parametrize("M,want", [(1, "gemv"), (4, "gemv"), (16, "gemv"),
                                    (17, "sm90"), (64, "sm90"),
                                    (2048, "sm90")])
def test_variant_by_rows_on_k_major_codes(M, want):
    xq, wq = _codes(M, 4096, 128)
    assert wq.stride() == (1, 4096)
    assert qmm_ops.variant(xq, wq) == want
    assert M <= qmm_ops.GEMV_MAX_ROWS or want == "sm90"
    assert qmm_ops.tma_codes(xq, wq) == (xq, wq)      # no copy


@pytest.mark.parametrize("M", [4, 2048])
def test_variant_needs_k_major_codes(M):
    """Row-major codes get a one-off K-major copy of the weights; the
    activations, which the kernels can read, are not copied."""
    xq, wq = _random_codes(*_codes(M, 4096, 128, k_major=False), M)
    assert wq.stride() == (128, 1) and not tma_readable(xq, wq)
    cx, cw = _copies_exactly(xq, wq)
    assert cx is xq and cw.stride() == (1, 4096)
    # a column-major copy of row-major codes is K-major
    assert tma_readable(xq, wq.T.contiguous().T)
    assert qmm_ops.variant(cx, cw) == qmm_ops.variant(xq, wq)


@pytest.mark.parametrize("K", [7, 30, 33, 200, 1030, 4104])
def test_variant_needs_k_a_multiple_of_16(K):
    """The reference test shapes' K: TMA rows must be 16-byte multiples,
    so both sides are zero-padded to the next one."""
    for M in (4, 300):
        xq, wq = _random_codes(*_codes(M, K, 96), K + M)
        assert not tma_readable(xq, wq)
        cx, cw = _copies_exactly(xq, wq)
        assert cx.shape[1] == K - K % 16 + 16
        assert not cx[:, K:].any() and not cw[K:].any()
    xq, wq = _codes(300, K - K % 16 + 16, 96)
    assert tma_readable(xq, wq)


def test_variant_needs_16_byte_bases_and_pitches():
    xq, wq = _random_codes(*_codes(300, 256, 96), 3)
    assert tma_readable(xq, wq)
    assert tma_readable(_shifted(xq, 0), _shifted(wq, 0))
    for off in (1, 4, 8):
        assert not tma_readable(_shifted(xq, off), wq)
        assert not tma_readable(xq, _shifted(wq, off))
        cx, cw = _copies_exactly(_shifted(xq, off), wq)
        assert cw is wq                  # only the unaligned side is copied
        cx, cw = _copies_exactly(xq, _shifted(wq, off))
        assert cx is xq
    # a K slice of wider K-major codes keeps its pitch: TMA reads it where
    # the pitch and the slice's start are 16-byte multiples
    wide = torch.ones(96, 512, dtype=torch.int8).T           # (512, 96)
    assert tma_readable(xq, wide[:256])
    assert tma_readable(xq, wide[16:272])
    assert not tma_readable(xq, wide[8:264])                 # base + 8
    odd = torch.ones(96, 520, dtype=torch.int8).T[:256]      # pitch 520
    assert odd.stride() == (1, 520)
    assert not tma_readable(xq, odd)
    assert qmm_ops.tma_codes(xq, odd)[1].stride() == (1, 256)
    # activation codes that are not row-major
    assert not tma_readable(xq.T.contiguous().T, wq)
    assert _copies_exactly(xq.T.contiguous().T, wq)[0].is_contiguous()


def test_variant_takes_one_output_channel():
    xq, wq = _codes(4, 64, 1)
    assert qmm_ops.variant(xq, wq) == "gemv"
    assert tma_readable(xq, wq)
    # (K, 1) row-major is K-major too
    assert tma_readable(xq, torch.ones(64, 1, dtype=torch.int8))


@pytest.mark.parametrize("M,K,N", [(1, 7, 5), (33, 30, 64), (130, 33, 257),
                                   (4, 4096, 128), (300, 1030, 131)])
@pytest.mark.parametrize("layout", ["k_major", "row_major"])
def test_tma_codes_keep_the_product_bit_for_bit(M, K, N, layout):
    """The copy the wrapper makes for codes the kernels cannot read (the
    card tests' B4 shapes, ragged K among them) changes no bit of the
    result; readable codes are handed on as they are."""
    xq, wq = _random_codes(*_codes(M, K, N, k_major=layout == "k_major"),
                           M * K + N)
    cx, cw = _copies_exactly(xq, wq)
    if tma_readable(xq, wq):
        assert cx is xq and cw is wq


def test_quant_matmul_cuda_refuses_a_layout_its_variant_cannot_read():
    """Raised before any library is loaded, so it runs here."""
    x_scale, w_scale = torch.ones(1), torch.ones(96)
    out = torch.empty(300, 96)
    xq, wq = _codes(300, 256, 96, k_major=False)
    for name in ("sm90", "gemv"):
        with pytest.raises(ValueError, match=f"quant_matmul {name}"):
            qmm_ops.quant_matmul_cuda(xq, wq, x_scale, w_scale, out,
                                      variant=name)
    xq, wq = _codes(300, 256, 96)
    with pytest.raises(ValueError, match="no variant 'mma'"):
        qmm_ops.quant_matmul_cuda(xq, wq, x_scale, w_scale, out,
                                  variant="mma")


def test_quant_matmul_counts_no_variant_on_the_cpu():
    tx, _, w = _qmm_case((20, 64, 32), torch.float32)
    ip = quantize_params_int8({"w": torch.from_numpy(w)})
    xq, _ = quantize_act(tx)
    assert qmm_ops.variant(xq, ip.q["w"]) == "sm90"
    before = (qmm_ops.launches, dict(qmm_ops.launches_by_variant))
    quant_matmul(tx, ip.q["w"], ip.scale["w"])
    assert (qmm_ops.launches, qmm_ops.launches_by_variant) == before


# ---- B6 ---------------------------------------------------------------------
def _ssd_case(shape, with_h0):
    """tests/test_kernels.py::test_mamba2_kernel's distributions."""
    B, S, H, P, N = shape
    rng = np.random.default_rng(sum(shape))
    x = _f32(rng, (B, S, H, P), 0.5)
    dt = np.log1p(np.exp(_f32(rng, (B, S, H)))).astype(np.float32)
    A = (-np.exp(_f32(rng, (H,), 0.3))).astype(np.float32)
    Bm, Cm = _f32(rng, (B, S, 1, N), 0.5), _f32(rng, (B, S, 1, N), 0.5)
    h0 = _f32(rng, (B, H, P, N), 0.1) if with_h0 else None
    return x, dt, A, Bm, Cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# the reference's shapes (test_kernels.py:152), chunk 16
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 16), (1, 128, 2, 32, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_matches_reference_wrapper_and_oracle(shape, with_h0):
    case = _ssd_case(shape, with_h0)
    before = ssd_ops.launches
    y, hf = ssd(*map(_t, case), chunk=16)
    assert ssd_ops.launches == before
    B, S, H, P, N = shape
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, P)
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (B, H, P, N)
    jc = tuple(map(_j, case))
    for want_y, want_h in (j_ssd(*jc, chunk=16),
                           j_ssd_reference(*jc[:5], h0=jc[5])):
        assert _err(y, want_y) < SSD_TOL
        assert _err(hf, want_h) < SSD_TOL


def test_ssd_step_and_oracle_match_reference():
    x, dt, A, Bm, Cm, h0 = _ssd_case((2, 9, 4, 8, 6), True)
    got = ssd_step(*map(_t, (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)))
    want = j_ssd_step(*map(_j, (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                h0)))
    for g, r in zip(got, want):
        assert _err(g, r) < 1e-6
    got = ssd_reference(*map(_t, (x, dt, A, Bm, Cm)), h0=_t(h0))
    want = j_ssd_reference(*map(_j, (x, dt, A, Bm, Cm)), h0=_j(h0))
    for g, r in zip(got, want):
        assert _err(g, r) < 1e-6


# ---- B7 ---------------------------------------------------------------------
def _wkv_case(shape, with_h0):
    """tests/test_kernels.py::test_wkv6_kernel's distributions."""
    B, S, H, N = shape
    rng = np.random.default_rng(sum(shape))
    r, k, v = (_f32(rng, shape, 0.5) for _ in range(3))
    w_log = (-np.exp(_f32(rng, shape, 0.5))).astype(np.float32)
    u = _f32(rng, (H, N), 0.5)
    h0 = _f32(rng, (B, H, N, N), 0.1) if with_h0 else None
    return r, k, v, w_log, u, h0


# the reference's shapes (test_kernels.py:135), chunk 32
@pytest.mark.parametrize("shape", [(2, 64, 3, 16), (1, 128, 2, 32),
                                   (2, 32, 4, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_wkv6_matches_reference_wrapper_and_oracle(shape, with_h0):
    case = _wkv_case(shape, with_h0)
    before = wkv_ops.launches
    y, hf = wkv6(*map(_t, case), chunk=32)
    assert wkv_ops.launches == before
    B, S, H, N = shape
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (B, H, N, N)
    jc = tuple(map(_j, case))
    for want_y, want_h in (j_wkv6(*jc, chunk=32),
                           j_wkv6_reference(*jc[:5], h0=jc[5])):
        assert _err(y, want_y) < WKV_TOL
        assert _err(hf, want_h) < WKV_TOL


def test_wkv6_step_and_oracle_match_reference():
    r, k, v, w_log, u, h0 = _wkv_case((2, 7, 3, 8), True)
    got = wkv6_step(*map(_t, (r[:, 0], k[:, 0], v[:, 0], w_log[:, 0], u,
                              h0)))
    want = j_wkv6_step(*map(_j, (r[:, 0], k[:, 0], v[:, 0], w_log[:, 0], u,
                                 h0)))
    for g, w in zip(got, want):
        assert _err(g, w) < 1e-6
    got = wkv6_reference(*map(_t, (r, k, v, w_log, u)), h0=_t(h0))
    want = j_wkv6_reference(*map(_j, (r, k, v, w_log, u)), h0=_j(h0))
    for g, w in zip(got, want):
        assert _err(g, w) < 1e-6


# ---- the slice as a whole: all four templates on one input set ---------------
def test_all_four_templates_in_one_pass_match_the_reference():
    """One seeded draw feeds the four port wrappers and the four JAX
    wrappers at small widths; every output within its template's bar."""
    rng = np.random.default_rng(13)
    x = _f32(rng, (40, 6, 2))
    w, b = _f32(rng, (2 + 12, 48), 0.3), _f32(rng, (48,), 0.1)
    errs = {"lstm_cell": _err(
        lstm_window(*map(torch.from_numpy, (x, w, b)), block_b=16),
        j_lstm_window(*map(jnp.asarray, (x, w, b)), block_b=16))}
    a, wq = _f32(rng, (24, 12)), _f32(rng, (12, 20))
    ip = quantize_params_int8({"w": torch.from_numpy(wq)})
    jip = j_quantize_params_int8({"w": jnp.asarray(wq)})
    errs["quant_matmul"] = _err(
        quant_matmul(torch.from_numpy(a), ip.q["w"], ip.scale["w"]),
        j_quant_matmul(jnp.asarray(a), jip.q["w"], jip.scale["w"]))
    case = _ssd_case((1, 32, 2, 8, 4), True)
    got, want = ssd(*map(_t, case), chunk=16), j_ssd(*map(_j, case),
                                                     chunk=16)
    errs["mamba2"] = max(_err(g, r) for g, r in zip(got, want))
    case = _wkv_case((1, 32, 2, 8), True)
    got, want = wkv6(*map(_t, case), chunk=16), j_wkv6(*map(_j, case),
                                                       chunk=16)
    errs["rwkv6"] = max(_err(g, r) for g, r in zip(got, want))
    bars = {"lstm_cell": LSTM_TOL, "quant_matmul": QMM_TOL,
            "mamba2": SSD_TOL, "rwkv6": WKV_TOL}
    assert all(errs[k] < bars[k] for k in bars), errs


# ---- contracts ----------------------------------------------------------------
def test_ssd_refuses_bad_shapes():
    x, dt, A, Bm, Cm, _ = map(_t, _ssd_case((1, 64, 2, 8, 4), False))
    with pytest.raises(ValueError, match="n_groups=1"):
        ssd(x, dt, A, torch.cat([Bm, Bm], 2), torch.cat([Cm, Cm], 2))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=24)
    with pytest.raises(ValueError, match="h0 must be"):
        ssd(x, dt, A, Bm, Cm, torch.zeros(1, 2, 8, 5))
    with pytest.raises(ValueError, match="dt must be"):
        ssd(x, dt[:, :-1], A, Bm, Cm)


def test_wkv6_refuses_bad_shapes():
    r, k, v, w_log, u, _ = map(_t, _wkv_case((1, 64, 2, 8), False))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv6(r, k, v, w_log, u, chunk=48)
    with pytest.raises(ValueError, match="multiple of 16"):
        wkv6(r, k, v, w_log, u, chunk=8)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w_log, u[:1])


def test_reference_refuses_the_same_shapes():
    """The port's ValueErrors stand for the reference's asserts."""
    x, dt, A, Bm, Cm, _ = map(_j, _ssd_case((1, 64, 2, 8, 4), False))
    with pytest.raises(AssertionError):
        j_ssd(x, dt, A, Bm, Cm, chunk=24)
    with pytest.raises(AssertionError):
        j_ssd(x, dt, A, jnp.concatenate([Bm, Bm], 2),
              jnp.concatenate([Cm, Cm], 2))
    r, k, v, w_log, u, _ = map(_j, _wkv_case((1, 64, 2, 8), False))
    with pytest.raises(AssertionError):
        j_wkv6(r, k, v, w_log, u, chunk=8)


def test_lstm_and_quant_matmul_refuse_bad_operands():
    x, w, b = map(torch.from_numpy, _lstm_case((4, 6, 1, 20)))
    with pytest.raises(ValueError, match="float32"):
        lstm_window(x.double(), w, b)
    with pytest.raises(ValueError, match="do not fit"):
        lstm_window(x, w[1:], b)
    with pytest.raises(ValueError, match="block_b"):
        lstm_window(x, w, b, block_b=0)
    a = torch.ones(3, 21)
    with pytest.raises(ValueError, match="int8"):
        quant_matmul(a, w.to(torch.int8).float(), torch.ones(80))
    with pytest.raises(ValueError, match="w_scale"):
        quant_matmul(a, w.to(torch.int8), torch.ones(79))


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is on neither the CPU, CUDA nor ``meta`` raises: no
    wrapper falls back to its plain version. On ``meta``, which computes
    nothing, each returns its empty result."""
    lstm = tuple(map(torch.from_numpy, _lstm_case((4, 6, 1, 20))))
    wkv = tuple(map(_t, _wkv_case((1, 16, 1, 4), False)[:5]))
    scan = tuple(map(_t, _ssd_case((1, 16, 1, 4, 4), False)[:5]))
    for fn, case in ((lstm_window, lstm), (wkv6, wkv), (ssd, scan)):
        want = fn(*case)
        got = fn(*(t.to("meta") for t in case))
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert (g.device.type, g.shape) == ("meta", w.shape)
        with pytest.raises(ValueError, match="no kernel for device xpu"):
            fn(*(t.as_subclass(_Elsewhere) for t in case))
