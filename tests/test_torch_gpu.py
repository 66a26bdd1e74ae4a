"""PyTorch port on the card (``gpu`` marker; skips without CUDA): each CUDA
kernel against its plain version, exact integer equality, and the emulator
on CUDA against the golden sets and its own plain path.

Imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_int_ref)
from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.kernels.mac_int import ops as mac_ops
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl.emulator import RTLEmulator, assert_bit_exact
from repro_torch.verify import vectors as tvec

pytestmark = pytest.mark.gpu

GOLDEN_ROOT = os.path.join(os.path.dirname(__file__), "golden", "vectors")
A, W, C = FxpFormat(8, 4), FxpFormat(8, 6), FxpFormat(16, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _codes(rng, fmt, shape, device):
    return torch.as_tensor(rng.integers(fmt.lo, fmt.hi + 1, shape),
                           dtype=torch.int32, device=device)


@pytest.mark.parametrize("B,S,din,hid", [(1, 6, 1, 20), (7, 6, 3, 16),
                                         (64, 4, 2, 8), (200, 6, 1, 20),
                                         (1000, 6, 20, 20), (129, 3, 8, 64)])
def test_lstm_window_kernel_matches_plain(cuda, B, S, din, hid):
    rng = np.random.default_rng(B + S)
    spec = CellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=A,
                    state_fmt=C, w_fmt=W, sig_lo=A.lo, tanh_lo=A.lo)
    args = (_codes(rng, A, (B, S, din), cuda),
            _codes(rng, W, (din + hid, 4 * hid), cuda),
            _codes(rng, FxpFormat(11, 0), (4 * hid,), cuda),
            _codes(rng, A, (2 ** A.total_bits,), cuda),
            _codes(rng, A, (2 ** A.total_bits,), cuda))
    before = lstm_ops.launches
    got = lstm_window_int(*args, spec=spec)
    assert lstm_ops.launches == before + 1
    assert torch.equal(got, lstm_window_int_ref(*args, spec=spec))


@pytest.mark.parametrize("shift", [-2, 0, 2, 6, 13])
@pytest.mark.parametrize("rows,K,N", [(7, 20, 1), (49, 9, 3), (21, 9, 3),
                                      (7, 9, 1), (7, 21, 80),
                                      (70001, 33, 5)])
def test_mac_kernel_matches_plain(cuda, rows, K, N, shift):
    rng = np.random.default_rng(rows + K + N + shift)
    fmt = C if shift <= 2 else A
    args = (_codes(rng, A, (rows, K), cuda), _codes(rng, W, (K, N), cuda),
            _codes(rng, FxpFormat(11, 0), (N,), cuda))
    before = mac_ops.launches
    got = mac_int_op(*args, shift=shift, lo=fmt.lo, hi=fmt.hi)
    assert mac_ops.launches == before + 1
    assert torch.equal(got, mac_int_ref(*args, shift=shift, lo=fmt.lo,
                                        hi=fmt.hi))


def test_mac_kernel_wraps_like_plain(cuda):
    xh = torch.full((3, 4), 2 ** 30 - 1, dtype=torch.int32, device=cuda)
    xh[1] *= -1
    w = torch.full((4, 2), 7, dtype=torch.int32, device=cuda)
    b = torch.tensor([2 ** 31 - 1, -(2 ** 31)], dtype=torch.int32,
                     device=cuda)
    kw = dict(shift=0, lo=-(2 ** 31), hi=2 ** 31 - 1)
    assert torch.equal(mac_int_op(xh, w, b, **kw), mac_int_ref(xh, w, b, **kw))


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
@pytest.mark.parametrize("mode", RTLEmulator.MODES)
def test_emulator_on_card(cuda, arch, mode):
    """Golden replay, fused/per-step = plain path, and the float oracle,
    with the emulator on the card."""
    graph, _, _ = tvec.canonical_graph(arch)
    vs = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    em = RTLEmulator(graph, mode=mode, device=cuda)
    got = em.run_int(vs.stimulus).outputs
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), vs.response)
    x = np.random.default_rng(1).standard_normal(
        (4099, *graph.edges["x"].shape)).astype(np.float32) * 3
    plain = RTLEmulator(graph, mode="jnp", device=cuda).run(x)
    assert torch.equal(em.run(x).outputs, plain.outputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert_bit_exact(graph, x, mode, device=cuda)
