"""PyTorch port on the card (``gpu`` marker; skips without CUDA): each CUDA
kernel against its plain version (exact integer equality for B1/B2; B5
within the reference's 2e-5 in f32 and 0.03 in bf16), the emulator on CUDA
against the golden sets and its own plain path, and the LM server with B5
against its plain attention path.

Imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_int_ref)
from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.kernels.mac_int import ops as mac_ops
from repro_torch.model.lm import Stepper
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl.emulator import RTLEmulator, assert_bit_exact
from repro_torch.runtime.server import Server, ServerConfig
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


# the reference's B5 test shapes, then ragged S, odd head dims and hd 256
FLASH_SHAPES = [(2, 256, 4, 64), (1, 512, 2, 128), (2, 256, 3, 96),
                (1, 384, 2, 160), (1, 17, 2, 64), (2, 100, 3, 80),
                (1, 1, 2, 16), (1, 70, 1, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, causal):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.as_tensor(rng.standard_normal(shape) * 0.5,
                               dtype=torch.float32, device=cuda)
               for _ in range(3))
    torch.backends.cuda.matmul.allow_tf32 = False
    before = flash_ops.launches
    got = flash_attention(q, k, v, causal)
    assert flash_ops.launches == before + 1
    want = attention_ref(q, k, v, causal)
    assert (got - want).abs().max().item() < 2e-5
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(qb, kb, vb, causal)
    assert got.dtype == torch.bfloat16
    want = attention_ref(qb.float(), kb.float(), vb.float(), causal)
    assert (got.float() - want).abs().max().item() < 0.03


def test_flash_kernel_takes_strided_views(cuda):
    """q/k/v as (B, H, S, hd) buffers seen through (B, S, H, hd) views."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 3, 70, 32)),
                               dtype=torch.float32, device=cuda)
               .transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, True)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    assert (got - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("arch", ["yi-9b", "stablelm-3b"])
def test_server_flash_equals_plain_attention_on_card(cuda, arch):
    """Smoke config in f32 on the card: the same greedy tokens with B5 as
    with the plain einsum attention, and n_layers launches per request."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in (16, 17, 5)]
    outs = {}
    for impl in ("ref", "flash"):
        par = ParallelismConfig(compute_dtype="float32", attn_impl=impl)
        params = Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                         par).init(seed=1, device=cuda)
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=32,
                                               eos_token=-1), SMOKE_MESH,
                     par, device=cuda)
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        before = flash_ops.launches
        outs[impl] = [r.out_tokens for r in srv.run_until_drained()]
        n = flash_ops.launches - before
        assert n == (cfg.n_layers * len(prompts) if impl == "flash" else 0)
    assert outs["flash"] == outs["ref"]
