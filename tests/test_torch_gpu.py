"""PyTorch port on the card (``gpu`` marker; skips without CUDA): each CUDA
kernel against its plain version (exact integer equality for B1/B2, B1's
``mma`` and ``simt`` variants each through the wrapper and directly; B5
within the reference's 2e-5 in f32 and 0.03 in bf16, bf16 also within
``BF16_REL_RMS_BAR`` of each 128-row block's rms, on the variant its
routing names and on ``simt`` at every bf16 shape; B3 within 1e-5, its
``mma`` and ``simt`` variants each through the wrapper and directly; B4 bit
for bit, each of its two variants launched directly and through the
wrapper; B6/B7 within 1e-4 on y and the final state of the per-step plain version
and of the chunked forms ``ssd_chunked``/``wkv6_chunked``, also at decay
extremes), the emulator on CUDA against the golden sets and its own
plain path, the verification half on CUDA (``run_conformance`` with B1/B2
launches counted, ``fuzz_template`` for every kind, ``emit_golden``,
``canary_check``, and ``oracle_codes`` under a TF32 global), the LM
server with B5 against its plain attention path, and the paper's loop on
the card (the QAT and float window losses and gradients against the CPU,
``RTLExecutable.measure``, ``verify_deployment``, the measurement protocol
on a real ``RTLExecutable``, one ``Workflow.run_once``), and the host
target (a deployment measured on the card with synchronised runs, a step's
counts on the card equal to its counts on ``meta``, B5 launched once a
layer by a deployed prefill), and the LM families (the MoE oracle and its
router's tie rule against the CPU, a DeepSeek-MoE-16B layer at full width
with B5 against plain attention, whisper-tiny's decode through its cached
cross K/V against a whole-sequence prefill), the hybrid and RWKV families
(``-k family``), the decode-attention kernel against its plain version
and launched once a layer a decode tick (``-k decode_attention``),
concurrent SEU flips against program replays, once
and 240 times in one process (``-k flips_under``), and spans timed on the
card: a span's device interval against CUDA events, its end against the
host's after a synchronize at the anchor and 50 s later, a traced server's
spans (``-k "device_interval or server_spans"``).

Imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import (SMOKE_MESH, LSTMConfig,
                                    ParallelismConfig, ShapeConfig)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (BF16_REL_RMS_BAR,
                                                     rel_rms_by_block)
from repro_torch.kernels.lstm_cell import (lstm_window, lstm_window_cuda,
                                           lstm_window_ref)
from repro_torch.kernels.lstm_cell import ops as lstm_f_ops
from repro_torch.kernels.lstm_cell.kernel import activation_sweep, mma_takes
from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_int_cuda,
                                               lstm_window_int_ref)
from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.kernels.mac_int import ops as mac_ops
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ssd, ssd_reference
from repro_torch.convert import to_torch
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.quant_matmul import (quant_matmul, quant_matmul_cuda,
                                              quant_matmul_ref, quantize_act)
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import wkv6, wkv6_reference
from repro_torch.model.lm import Stepper
from repro_torch.model.rwkv import wkv6_chunked
from repro_torch.model.ssm import ssd_chunked
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.quant.ptq import Int8Params, quantize_params_int8
from repro_torch.rtl.emulator import (RTLEmulator, assert_bit_exact,
                                      reference_apply)
from repro_torch.rtl.ir import Edge, Graph, LinearNode, lower_model
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.verify import vectors as tvec
from repro_torch.verify.conformance import (canary_check, fuzz_template,
                                            oracle_codes, run_conformance)

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


# B1's formats by the variant the wrapper routes them to: Table I's 8-bit
# codes go to ``mma``, 12-bit activation codes to ``simt``
B1_FORMATS = {"mma": (A, W, C), "simt": (FxpFormat(12, 6), W, C)}


def _b1_case(rng, B, S, din, hid, act, w_fmt, state, device):
    spec = CellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=act,
                    state_fmt=state, w_fmt=w_fmt, sig_lo=act.lo,
                    tanh_lo=act.lo)
    args = (_codes(rng, act, (B, S, din), device),
            _codes(rng, w_fmt, (din + hid, 4 * hid), device),
            _codes(rng, FxpFormat(11, 0), (4 * hid,), device),
            _codes(rng, act, (2 ** act.total_bits,), device),
            _codes(rng, act, (2 ** act.total_bits,), device))
    return spec, args


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("B,S,din,hid", [(1, 6, 1, 20), (7, 6, 3, 16),
                                         (64, 4, 2, 8), (200, 6, 1, 20),
                                         (1000, 6, 20, 20), (129, 3, 8, 64),
                                         (33, 6, 2, 5), (17, 6, 1, 13),
                                         (65, 5, 3, 30)])
def test_lstm_window_kernel_matches_plain(cuda, B, S, din, hid, variant):
    """Through the wrapper, which routes each format to its variant."""
    rng = np.random.default_rng(B + S)
    spec, args = _b1_case(rng, B, S, din, hid, *B1_FORMATS[variant], cuda)
    assert lstm_ops.variant(spec) == variant
    before = lstm_ops.launches
    by_variant = dict(lstm_ops.launches_by_variant)
    got = lstm_window_int(*args, spec=spec)
    assert lstm_ops.launches == before + 1
    by_variant[variant] += 1
    assert lstm_ops.launches_by_variant == by_variant
    assert torch.equal(got, lstm_window_int_ref(*args, spec=spec))


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("hid", [5, 8, 13, 16, 20, 30, 32, 64])
@pytest.mark.parametrize("B", [1, 15, 17, 65537])
def test_lstm_window_variants_launched_directly(cuda, B, hid, variant):
    """Each variant on Table I's formats: ragged 16-window tiles and
    128-thread blocks, every hidden width of the mma kernel's instances,
    and widths that are not multiples of 4 (mma's int32 store path and
    padded units past hidden in its last n8 tile)."""
    rng = np.random.default_rng(B * 100 + hid)
    spec, args = _b1_case(rng, B, 6, 3, hid, A, W, C, cuda)
    out = torch.full((B, 6, hid), -7, dtype=torch.int32, device=cuda)
    lstm_window_int_cuda(*args, out, spec=spec, variant=variant)
    assert torch.equal(out, lstm_window_int_ref(*args, spec=spec))


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("din,hid", [(1, 20), (64, 64)])
@pytest.mark.parametrize("rom_fill", ["lo", "hi"])
@pytest.mark.parametrize("w_fill", ["lo", "hi"])
@pytest.mark.parametrize("x_fill", ["lo", "hi"])
def test_lstm_window_extreme_codes(cuda, x_fill, w_fill, rom_fill, din,
                                   hid, variant):
    """Every x, W and ROM code at its format's end, biases at int32's: at
    K = 128, |x . w| summed reaches 2^21, the top of the mma kernel's
    exactness envelope, and adding the bias wraps."""
    spec = CellSpec(seq_len=6, d_in=din, hidden=hid, act_fmt=A, state_fmt=C,
                    w_fmt=W, sig_lo=A.lo, tanh_lo=A.lo)

    def fill(fmt, which, shape):
        return torch.full(shape, fmt.lo if which == "lo" else fmt.hi,
                          dtype=torch.int32, device=cuda)

    b = torch.where(torch.arange(4 * hid, device=cuda) % 2 == 0,
                    torch.tensor(2 ** 31 - 1, dtype=torch.int32, device=cuda),
                    torch.tensor(-2 ** 31, dtype=torch.int32, device=cuda))
    args = (fill(A, x_fill, (33, 6, din)), fill(W, w_fill, (din + hid,
                                                            4 * hid)),
            b, fill(A, rom_fill, (256,)), fill(A, rom_fill, (256,)))
    out = torch.empty((33, 6, hid), dtype=torch.int32, device=cuda)
    lstm_window_int_cuda(*args, out, spec=spec, variant=variant)
    assert torch.equal(out, lstm_window_int_ref(*args, spec=spec))


def test_lstm_mma_refuses_w_outside_its_format_on_card(cuda):
    """A W code outside w_fmt never reaches the mma kernel: the mma
    launcher refuses it with a ValueError (nothing is launched, no trap),
    and the wrapper routes it to simt, which equals the plain version; the
    context stays usable."""
    rng = np.random.default_rng(5)
    spec, args = _b1_case(rng, 40, 6, 1, 20, A, W, C, cuda)
    bad = args[1].clone()
    bad[0, 0] = W.hi + 1
    out = torch.empty((40, 6, 20), dtype=torch.int32, device=cuda)
    before = lstm_ops.launches
    with pytest.raises(ValueError, match="outside"):
        lstm_window_int_cuda(args[0], bad, *args[2:], out, spec=spec,
                             variant="mma")
    assert lstm_ops.launches == before
    simt = lstm_ops.launches_by_variant["simt"]
    assert torch.equal(lstm_window_int(args[0], bad, *args[2:], spec=spec),
                       lstm_window_int_ref(args[0], bad, *args[2:],
                                           spec=spec))
    assert lstm_ops.launches_by_variant["simt"] == simt + 1
    assert torch.equal(lstm_window_int(*args, spec=spec),
                       lstm_window_int_ref(*args, spec=spec))
    torch.cuda.synchronize()


@pytest.mark.parametrize("variant", ["mma", "simt"])
def test_lstm_two_layer_design_on_card(cuda, variant):
    """A two-cell LSTM lowered by ``lower_model`` (8-bit codes -> mma,
    12-bit -> simt): fused = the plain path = the float oracle on CUDA, one
    launch per cell, all of the routed variant."""
    act, _, _ = B1_FORMATS[variant]
    cfg = get_config("elastic-lstm")
    cfg = cfg.with_(n_layers=2, lstm=LSTMConfig(
        hidden=20, n_layers=2, in_features=1, out_features=1, seq_len=6))
    graph = lower_model(cfg, tvec.canonical_params(tvec.schema_for(cfg),
                                                   seed=11),
                        act_fmt=act, state_fmt=FxpFormat(12, 8)
                        if variant == "simt" else C)
    x = np.random.default_rng(2).standard_normal(
        (4099, *graph.edges["x"].shape)).astype(np.float32) * 3
    em = RTLEmulator(graph, mode="fused", device=cuda)
    lstm_ops.launches_by_variant = dict.fromkeys(
        lstm_ops.launches_by_variant, 0)
    got = em.run(x)
    assert lstm_ops.launches_by_variant == {
        "mma": 0, "simt": 0, variant: 2}
    plain = RTLEmulator(graph, mode="jnp", device=cuda).run(x)
    assert torch.equal(got.outputs, plain.outputs)
    for name, seq in plain.trace.items():
        assert torch.equal(got.trace[name], seq), name
    torch.backends.cuda.matmul.allow_tf32 = False
    assert_bit_exact(graph, x, mode="fused", device=cuda)


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
    assert_bit_exact(graph, x, mode=mode, device=cuda)


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
    assert rel_rms_by_block(got, want) < BF16_REL_RMS_BAR


def _bf16(rng, shape, device):
    return torch.as_tensor(rng.standard_normal(shape) * 0.5,
                           dtype=torch.float32, device=device).to(
                               torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_simt_bf16_matches_plain(cuda, shape, causal):
    """The simt variant's bf16 instances, which the routing now reaches
    only for hd > 128, hd % 8 != 0 or strides TMA cannot read, launched
    directly at every shape."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_bf16(rng, shape, cuda) for _ in range(3))
    got = torch.empty_like(q)
    flash_attention_cuda(q, k, v, got, causal=causal, variant="simt")
    want = attention_ref(q.float(), k.float(), v.float(), causal)
    assert (got.float() - want).abs().max().item() < 0.03
    assert rel_rms_by_block(got, want) < BF16_REL_RMS_BAR


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


# the sm90 variant: every head dim of the zoo up to 128, S around the
# 128-row tiles, and a Yi-9B prefill length
SM90_HDS = (64, 80, 112, 128)
SM90_SEQS = (1, 17, 127, 128, 129, 255, 2048)


def _flash_on_variant(q, k, v, causal, name):
    """B5 through its wrapper: ``name``'s counter, and only it, moves by
    one, and the bf16 output is within the reference's 0.03 of the f32
    plain version on the same (bf16) inputs and within
    ``BF16_REL_RMS_BAR`` of it in each 128-row block."""
    before = dict(flash_ops.launches_by_variant)
    got = flash_attention(q, k, v, causal)
    after = flash_ops.launches_by_variant
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == name) for n in after}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q.float(), k.float(), v.float(), causal)
    err = (got.float() - want).abs().max().item()
    assert err < 0.03, err
    err = rel_rms_by_block(got, want)
    assert err < BF16_REL_RMS_BAR, err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SM90_SEQS)
@pytest.mark.parametrize("hd", SM90_HDS)
def test_flash_sm90_matches_plain(cuda, hd, S, causal):
    rng = np.random.default_rng(hd + S)
    q, k, v = (_bf16(rng, (2, S, 3, hd), cuda) for _ in range(3))
    _flash_on_variant(q, k, v, causal, "sm90")


@pytest.mark.parametrize("Sq,Sk", [(17, 300), (200, 64), (1, 129),
                                   (300, 2048)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_sm90_cross_lengths(cuda, hd, Sq, Sk):
    """Not causal, Sq != Sk: Q and K/V have tensor maps of their own."""
    rng = np.random.default_rng(hd + Sq + Sk)
    q = _bf16(rng, (2, Sq, 3, hd), cuda)
    k, v = (_bf16(rng, (2, Sk, 3, hd), cuda) for _ in range(2))
    _flash_on_variant(q, k, v, False, "sm90")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_sm90_takes_strided_views(cuda, causal):
    """bf16 (B, H, S, hd) buffers seen through (B, S, H, hd) views."""
    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng, (2, 3, 200, 64), cuda).transpose(1, 2)
               for _ in range(3))
    assert not q.is_contiguous()
    _flash_on_variant(q, k, v, causal, "sm90")


def test_flash_bf16_goes_to_simt_where_tma_cannot(cuda):
    """hd 160, hd 100 (not a multiple of 8), and a row stride of 136
    bytes, stay on the CUDA cores."""
    rng = np.random.default_rng(12)
    q, k, v = (_bf16(rng, (1, 130, 2, 100), cuda) for _ in range(3))
    _flash_on_variant(q, k, v, True, "simt")
    q, k, v = (_bf16(rng, (1, 130, 2, 160), cuda) for _ in range(3))
    _flash_on_variant(q, k, v, True, "simt")
    q, k, v = (_bf16(rng, (1, 130, 2, 68), cuda)[..., :64] for _ in range(3))
    _flash_on_variant(q, k, v, True, "simt")


@pytest.mark.parametrize("arch", ["yi-9b", "stablelm-3b"])
def test_server_flash_equals_plain_attention_on_card(cuda, arch):
    """Smoke config in f32 on the card: the same greedy tokens with B5 and
    the decode kernel as with the plain einsum attention, and n_layers B5
    launches per request."""
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
        before = flash_ops.launches, dec_ops.launches_by_variant["simt"]
        outs[impl] = [r.out_tokens for r in srv.run_until_drained()]
        n = flash_ops.launches - before[0]
        assert n == (cfg.n_layers * len(prompts) if impl == "flash" else 0)
        n = dec_ops.launches_by_variant["simt"] - before[1]
        assert (n > 0) == (impl == "flash")
    assert outs["flash"] == outs["ref"]


# ---- the decode-attention kernel ------------------------------------------

def _lengths(B, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, B).tolist()


# (B, S_max, KV, G, hd, kv_len): yi-9b.long_decode's and long_prompt's
# pools, Zamba2-7B's shared block, the zoo's other groups and head dims
# (InternVL2-1B's G 7, StableLM-12B's hd 160, StableLM-3B's and
# whisper's MHA), a smoke config, and ragged edges: a length of 1, S_max,
# a free slot past it (S_max + 5), S_max not a whole number of tiles
DECODE_SHAPES = [
    (32, 4096, 4, 8, 128, _lengths(32, 297, 2160, 1)),
    (16, 4096, 4, 8, 128, _lengths(16, 512, 4032, 2)),
    (4, 4096, 32, 1, 112, [2048, 1, 4096, 4101]),
    (3, 300, 2, 7, 64, [1, 299, 305]),
    (2, 1000, 8, 4, 160, [999, 17]),
    (2, 500, 32, 1, 80, [64, 65]),
    (2, 1500, 6, 1, 64, [1500, 700]),
    (2, 32, 2, 2, 16, [5, 37]),
    (4, 777, 8, 8, 128, [1, 64, 128, 777]),
]


def _decode_case(shape, dtype, device):
    B, S, KV, G, hd, lens = shape
    rng = np.random.default_rng(B * S + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=device).to(dtype)
               for s in ((B, 1, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_decode_attention_kernel_matches_plain(cuda, shape, dtype):
    """The kernel of each dtype through its wrapper (its counter, and only
    it, moves by one) against the plain version in f32 on the same inputs:
    f32 within B5's 2e-5; bf16 within 0.03 and within
    ``BF16_REL_RMS_BAR`` of each (row, head)'s rms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, kv_len = _decode_case(shape, dtype, cuda)
    name = {torch.float32: "simt", torch.bfloat16: "mma"}[dtype]
    before = dict(dec_ops.launches_by_variant)
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    after = dec_ops.launches_by_variant
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == name) for n in after}
    assert got.dtype == dtype and got.shape == q.shape
    want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len)
    err = (got.float() - want).abs().max().item()
    if dtype == torch.float32:
        assert err < 2e-5, err
    else:
        assert err < 0.03, err
        rr = rel_rms_by_block(got, want)
        assert rr < BF16_REL_RMS_BAR, rr


def test_decode_attention_reads_only_each_rows_keys(cuda):
    """Keys past a row's length (and the free slot's past S_max) never
    reach the output: the cache past them set to 1e4 gives the same bf16
    output bit for bit."""
    q, k, v, kv_len = _decode_case(DECODE_SHAPES[0], torch.bfloat16, cuda)
    got = decode_attention(q, k, v, kv_len)
    for b, n in enumerate(kv_len.tolist()):
        k[b, n:] = 1e4
        v[b, n:] = 1e4
    assert torch.equal(decode_attention(q, k, v, kv_len), got)


def test_decode_attention_takes_the_rank_kv_views(cuda):
    """K/V as a slice of a wider cache's kv heads (the ``"model"`` split's
    run of whole groups) and as a head-gathered copy (G = 1)."""
    q, k, v, kv_len = _decode_case(DECODE_SHAPES[4], torch.bfloat16, cuda)
    ks, vs = k[:, :, 2:4], v[:, :, 2:4]
    qs = q[:, :, 8:16]
    got = decode_attention(qs, ks, vs, kv_len)
    want = decode_attention_ref(qs.float(), ks.float(), vs.float(), kv_len)
    assert rel_rms_by_block(got, want) < BF16_REL_RMS_BAR
    idx = [i // 4 for i in range(8, 16)]
    kg, vg = k[:, :, idx], v[:, :, idx]
    got = decode_attention(qs, kg, vg, kv_len)
    want = decode_attention_ref(qs.float(), kg.float(), vg.float(), kv_len)
    assert rel_rms_by_block(got, want) < BF16_REL_RMS_BAR


def test_decode_attention_refuses_what_it_does_not_take(cuda):
    """No fallback on the card: G > 16, a bf16 hd that is not a multiple
    of 8, and bf16 K/V rows off 16 bytes all raise, and launch nothing."""
    before = dec_ops.launches
    q, k, v, kv_len = _decode_case((2, 64, 1, 17, 64, [3, 4]),
                                   torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="at most 16"):
        decode_attention(q, k, v, kv_len)
    q, k, v, kv_len = _decode_case((2, 64, 2, 2, 100, [3, 4]),
                                   torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="hd % 8"):
        decode_attention(q, k, v, kv_len)
    q, k, v, kv_len = _decode_case((2, 64, 2, 2, 68, [3, 4]),
                                   torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(q[..., 4:], k[..., 4:], v[..., 4:], kv_len)
    assert dec_ops.launches == before


def test_server_decode_attention_launches_once_a_layer_a_tick(cuda):
    """A smoke Yi-9B served in bf16 with ``attn_impl="flash"``: the decode
    kernel launches ``n_layers`` times a decode tick (``mma``), and B5
    ``n_layers`` times a request."""
    from repro_torch.obs import Tracer, find_spans, set_tracer

    cfg = get_config("yi-9b", smoke=True)
    par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    params = Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                     par).init(seed=1, device=cuda,
                               dtype_override=torch.bfloat16)
    srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=32,
                                           eos_token=-1), SMOKE_MESH, par,
                 device=cuda)
    for n in (16, 17, 5):
        srv.submit(list(range(2, 2 + n)), max_new_tokens=6)
    tracer = Tracer()
    prev = set_tracer(tracer)
    before = (dec_ops.launches, dec_ops.launches_by_variant["mma"],
              flash_ops.launches)
    try:
        done = srv.run_until_drained()
    finally:
        set_tracer(prev)
    torch.cuda.synchronize()
    ticks = len(find_spans(tracer.spans, "server.decode"))
    assert ticks > 0 and all(len(r.out_tokens) == 6 for r in done)
    assert (dec_ops.launches - before[0],
            dec_ops.launches_by_variant["mma"] - before[1],
            flash_ops.launches - before[2]) == (
                cfg.n_layers * ticks, cfg.n_layers * ticks, cfg.n_layers * 3)


# ---- spans timed on the card (``Tracer.span(device=)``) ---------------------


def test_device_interval_of_a_timed_matmul_on_card(cuda):
    """A span's device interval around 20 bf16 matmuls of 8,192 against
    CUDA events recorded just inside it: within 2%."""
    from repro_torch.obs import Tracer

    g = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16,
                        generator=g) for _ in range(2))
    for _ in range(3):
        a @ b
    trc = Tracer()
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with trc.span("mm", device=cuda):
            e0.record()
            for _ in range(20):
                a @ b
            e1.record()
        torch.cuda.synchronize()
        s = trc.spans[-1]
        want = e0.elapsed_time(e1) / 1e3
        got = s.dev_end - s.dev_start
        print(f"matmul span: device {got * 1e3:.4f} ms, events "
              f"{want * 1e3:.4f} ms, host {s.duration * 1e3:.4f} ms")
        assert abs(got - want) <= 0.02 * want


def test_device_interval_ends_with_the_host_after_a_synchronize_on_card(
        cuda):
    """A span closed after ``torch.cuda.synchronize()`` ends on the device
    no later than on the host and within 1 ms of it, at the card's first
    timed span (the anchor) and 50 s later."""
    import time

    from repro_torch.obs import Tracer

    a = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    trc = Tracer()
    for wait in (0.0, 50.0):
        time.sleep(wait)
        with trc.span("synced", device=cuda):
            for _ in range(10):
                a @ a
            torch.cuda.synchronize()
        s = trc.spans[-1]
        print(f"after {wait:.0f} s: host end - device end "
              f"{(s.end - s.dev_end) * 1e6:.2f} us, device "
              f"{(s.dev_end - s.dev_start) * 1e3:.4f} ms of host "
              f"{s.duration * 1e3:.4f} ms")
        assert s.start <= s.dev_start <= s.dev_end <= s.end
        assert s.end - s.dev_end <= 1e-3


def test_server_spans_on_card(cuda):
    """A smoke Yi-9B served in bf16 with B5 and tracing on: the same greedy
    tokens as untraced; every ``model.*`` and ``server.prefill`` span has a
    device interval inside its host span's start and its tick's end; a
    decode forward's halves sum to no more than its device time, which is
    no more than its ``server.decode``'s host time."""
    from repro_torch.obs import capture, children_of, find_spans

    cfg = get_config("yi-9b", smoke=True)
    par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    params = Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                     par).init(seed=1, device=cuda,
                               dtype_override=torch.bfloat16)
    prompts = [list(range(2, 2 + n)) for n in (16, 17, 5)]

    def serve():
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=32,
                                               eos_token=-1), SMOKE_MESH,
                     par, device=cuda)
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        return [r.out_tokens for r in srv.run_until_drained()]

    plain = serve()
    with capture("serve") as cap:
        traced = serve()
    torch.cuda.synchronize()
    assert traced == plain
    spans = cap.trace.spans
    timed = [s for s in spans if s.name.startswith("model.")
             or s.name == "server.prefill"]
    assert timed and all(s.dev_start is not None for s in timed)
    ticks = {s.span_id: s for s in find_spans(spans, "server.tick")}
    for s in timed:
        # the anchor places the device clock within the jitter of an
        # event's record on an idle stream (tens of microseconds)
        assert s.start - 1e-4 <= s.dev_start <= s.dev_end
    for dec in find_spans(spans, "server.decode"):
        (fwd,) = children_of(spans, dec)
        halves = children_of(spans, fwd)
        assert len(halves) == 2 * cfg.n_layers
        assert sum(h.dev_end - h.dev_start for h in halves) <= (
            fwd.dev_end - fwd.dev_start) <= dec.duration
        assert fwd.dev_end <= ticks[dec.parent_id].end


# ---- B3, B4, B6, B7: the wrapper-only templates ----------------------------
# the reference's B3 test shapes, then ragged tiles, wider cells and one
# window; (B, S, d_in, H, block_b)
LSTM_SHAPES = [(64, 6, 1, 20, 128), (128, 6, 1, 20, 128), (32, 12, 4, 32, 128),
               (200, 6, 1, 20, 128), (1, 6, 1, 20, 128), (1000, 6, 20, 20, 7),
               (129, 3, 8, 64, 128), (300, 5, 3, 100, 64),
               (70, 3, 100, 128, 128)]      # W (0.5 MB) read from global


B3_TOL = 1e-5                  # the reference test's bar (test_kernels.py:88)


def _b3_case(B, S, din, hid, device, x_scale=1.0, seed=None):
    """The reference test's distributions, x scaled by ``x_scale``; the
    seed is ``B + S + din + hid`` unless given."""
    rng = np.random.default_rng(B + S + din + hid if seed is None else seed)
    x = torch.as_tensor(rng.standard_normal((B, S, din)) * x_scale,
                        dtype=torch.float32, device=device)
    w = torch.as_tensor(rng.standard_normal((din + hid, 4 * hid)) * 0.3,
                        dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal(4 * hid) * 0.1,
                        dtype=torch.float32, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in f32
    return x, w, b


def _b3_direct(variant, x, w, b, bb=128):
    """One launch of the named variant, into an output poisoned with NaN."""
    out = torch.full((x.shape[0], w.shape[1] // 4), float("nan"),
                     device=x.device)
    lstm_window_cuda(x, w, b, out, block_b=bb, variant=variant)
    torch.cuda.synchronize()
    return out


def _b3_err(got, x, w, b):
    return (got - lstm_window_ref(x, w, b)).abs().max().item()


@pytest.mark.parametrize("B,S,din,hid,bb", LSTM_SHAPES)
def test_lstm_window_float_kernel_matches_plain(cuda, B, S, din, hid, bb):
    """Through the wrapper, which launches the variant its routing names."""
    x, w, b = _b3_case(B, S, din, hid, cuda, seed=B + S + hid)
    name = lstm_f_ops.variant(x, w)
    before = lstm_f_ops.launches
    by_variant = dict(lstm_f_ops.launches_by_variant)
    got = lstm_window(x, w, b, block_b=bb)
    assert lstm_f_ops.launches == before + 1
    by_variant[name] += 1
    assert lstm_f_ops.launches_by_variant == by_variant
    assert got.shape == (B, hid) and got.dtype == torch.float32
    assert _b3_err(got, x, w, b) < B3_TOL


@pytest.mark.parametrize("variant,B,S,din,hid,bb", [
    (v, *shape) for v in ("mma", "simt") for shape in LSTM_SHAPES
    if v == "simt" or mma_takes(shape[2], shape[3])])
def test_lstm_window_float_variants_launched_directly(cuda, variant, B, S,
                                                     din, hid, bb):
    """Each variant at every shape inside its envelope (simt: all)."""
    x, w, b = _b3_case(B, S, din, hid, cuda)
    assert _b3_err(_b3_direct(variant, x, w, b, bb), x, w, b) < B3_TOL


# one cell for each mma instance (n8 tiles x k8 steps: (10, 3), (10, 5),
# (10, 8), (10, 16), (16, 3), (16, 5), (16, 8), (16, 16), (32, 5), (32, 8),
# (32, 16), the last with W split at each use), with d_in = 0 (the A tile
# holds h alone) and an odd H (a padded unit); (d_in, H)
MMA_CELLS = [(0, 20), (3, 13), (1, 20), (20, 20), (40, 20), (100, 20),
             (2, 22), (4, 32), (32, 32), (96, 32), (1, 39), (1, 63),
             (64, 64)]


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("din,hid", MMA_CELLS)
def test_lstm_window_float_every_mma_instance(cuda, din, hid, variant):
    x, w, b = _b3_case(70, 5, din, hid, cuda)
    assert _b3_err(_b3_direct(variant, x, w, b), x, w, b) < B3_TOL


@pytest.mark.parametrize("shape,want", [((4096, 6, 1, 20), "mma"),
                                        ((32, 12, 4, 32), "mma"),
                                        ((70, 3, 100, 128), "simt")])
def test_lstm_window_float_routing_on_card(cuda, shape, want):
    x, w, b = _b3_case(*shape, cuda)
    lstm_f_ops.launches_by_variant = dict.fromkeys(
        lstm_f_ops.launches_by_variant, 0)
    got = lstm_window(x, w, b)
    assert lstm_f_ops.launches_by_variant == {"mma": 0, "simt": 0, want: 1}
    assert _b3_err(got, x, w, b) < B3_TOL


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("bb", [7, 64])
@pytest.mark.parametrize("B", [1, 15, 17, 200])
def test_lstm_window_float_ragged_batches(cuda, B, bb, variant):
    """Ragged 16-window tiles (mma) and blocks (simt); bb changes no bit."""
    x, w, b = _b3_case(B, 6, 1, 20, cuda)
    got = _b3_direct(variant, x, w, b, bb)
    assert _b3_err(got, x, w, b) < B3_TOL
    assert torch.equal(got, _b3_direct(variant, x, w, b, 128))


@pytest.mark.parametrize("variant", ["mma", "simt"])
def test_lstm_window_float_zero_steps_give_zero(cuda, variant):
    x, w, b = _b3_case(33, 0, 1, 20, cuda)
    assert torch.equal(_b3_direct(variant, x, w, b),
                       torch.zeros(33, 20, device=cuda))


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("din,hid", [(1, 20), (4, 32)])
def test_lstm_window_float_long_window_does_not_drift(cuda, din, hid,
                                                      variant):
    """256 steps: several of mma's x chunks, and every step's rounding fed
    back through h and c."""
    x, w, b = _b3_case(100, 256, din, hid, cuda)
    assert _b3_err(_b3_direct(variant, x, w, b), x, w, b) < B3_TOL


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("din,hid", [(1, 20), (4, 32)])
def test_lstm_window_float_saturated_gates(cuda, din, hid, variant):
    """x scaled by 30: most gates sit in the tails of sigmoid and tanh."""
    x, w, b = _b3_case(100, 6, din, hid, cuda, x_scale=30.0)
    assert _b3_err(_b3_direct(variant, x, w, b), x, w, b) < B3_TOL


@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("din,hid", [(1, 20), (4, 32)])
def test_lstm_window_float_nan_window_gives_nan_row(cuda, din, hid,
                                                    variant):
    """A window whose x holds an Inf and, later, a NaN: its row of h is NaN
    in both variants, as in the plain version (mma's exponent clamp lets a
    NaN through), and every other row still matches the plain version."""
    x, w, b = _b3_case(40, 6, din, hid, cuda)
    x[17, 1, 0], x[17, 4, din - 1] = float("inf"), float("nan")
    got, want = _b3_direct(variant, x, w, b), lstm_window_ref(x, w, b)
    assert torch.isnan(want[17]).all() and torch.isnan(got[17]).all()
    rest = torch.arange(40, device=cuda) != 17
    assert torch.isfinite(got[rest]).all()
    assert (got[rest] - want[rest]).abs().max().item() < B3_TOL


@pytest.mark.parametrize("variant", ["mma", "simt"])
def test_lstm_window_float_saturated_widest_cell_against_f64(cuda, variant):
    """The widest mma cell, (d_in, H) = (64, 64), with x scaled by 30: the
    gate sums reach |z| ~ 100, where f32 rounding alone moves h by about
    1e-5 (chip_smoke.py phase 9 prints the f32 plain version's own
    distance from the f64 recurrence), so the f32 plain version cannot
    referee a 1e-5 bar; both variants are held to the f64 plain version
    within twice that bar."""
    x, w, b = _b3_case(100, 6, 64, 64, cuda, x_scale=30.0)
    want = lstm_window_ref(x.double(), w.double(), b.double())
    got = _b3_direct(variant, x, w, b).double()
    assert (got - want).abs().max().item() < 2 * B3_TOL


def test_lstm_window_float_mufu_activations_match_accurate(cuda):
    """mma's activations (ex2.approx, rcp.approx and a Newton step) against
    simt's accurate ones over a dense sweep of [-30, 30]."""
    z = torch.linspace(-30, 30, 2_000_001, device=cuda)
    sig_mufu, sig, tanh_mufu, tanh = activation_sweep(z).unbind(1)
    assert (sig_mufu - sig).abs().max().item() <= 1e-6
    assert (tanh_mufu - tanh).abs().max().item() <= 1e-6
    assert (sig - torch.sigmoid(z)).abs().max().item() <= 1e-6
    assert (tanh - torch.tanh(z)).abs().max().item() <= 1e-6


def test_lstm_window_float_mma_launcher_refuses_outside_its_envelope(cuda):
    """The C launcher itself returns an error for a cell mma has no
    instance for (the Python launcher raises before it is reached)."""
    from repro_torch.kernels.lstm_cell import kernel as lstm_f_kernel

    x, w, b = _b3_case(16, 3, 1, 65, cuda)
    out = torch.empty(16, 65, device=cuda)
    err = lstm_f_kernel._lib().lstm_cell_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 16, 3, 1,
        65, 128, lstm_f_kernel.VARIANTS["mma"],
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(ValueError, match="mma kernel does not take"):
        _b3_direct("mma", x, w, b)


# the reference's B4 test shapes (M, K, N), then ragged M/K/N, a decode tick
QMM_SHAPES = [(128, 128, 128), (64, 200, 96), (256, 512, 384), (32, 96, 640),
              (1, 7, 5), (130, 33, 257), (4, 4096, 128), (300, 1030, 131),
              (70, 64, 30), (33, 30, 64)]   # K % 16 != 0: padded copies


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", QMM_SHAPES)
def test_quant_matmul_kernel_equals_plain(cuda, M, K, N, dtype):
    """Bit for bit: the int32 sums are exact and the epilogue multiplies in
    the plain version's order."""
    rng = np.random.default_rng(M + K + N)
    x = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype,
                        device=cuda)
    w = torch.as_tensor(rng.standard_normal((K, N)), dtype=torch.float32,
                        device=cuda)
    ip = quantize_params_int8({"w": w})
    before = qmm_ops.launches
    got = quant_matmul(x, ip.q["w"], ip.scale["w"])
    assert qmm_ops.launches == before + 1
    want = quant_matmul(x, ip.q["w"], ip.scale["w"], use_ref=True)
    assert qmm_ops.launches == before + 1
    assert torch.equal(got, want)
    # row-major codes: the wrapper copies them K-major for the same variant
    name = qmm_ops.variant(quantize_act(x)[0], ip.q["w"])
    before = qmm_ops.launches_by_variant[name]
    assert torch.equal(quant_matmul(x, ip.q["w"].contiguous(),
                                    ip.scale["w"]), want)
    assert qmm_ops.launches_by_variant[name] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel_reads_a_transposed_x(cuda, dtype):
    """A column-major x (a transposed tensor) gives column-major codes; the
    kernels read row-major ones, so the wrapper must hand them a copy."""
    rng = np.random.default_rng(7)
    xt = torch.as_tensor(rng.standard_normal((200, 65)), dtype=dtype,
                         device=cuda)
    w = torch.as_tensor(rng.standard_normal((200, 96)), dtype=torch.float32,
                        device=cuda)
    ip = quantize_params_int8({"w": w})
    x = xt.T
    assert not x.is_contiguous()
    got = quant_matmul(x, ip.q["w"], ip.scale["w"])
    want = quant_matmul(x.contiguous(), ip.q["w"], ip.scale["w"],
                        use_ref=True)
    assert torch.equal(got, want)
    before = qmm_ops.launches_by_variant["sm90"]
    assert torch.equal(quant_matmul(x, ip.q["w"].contiguous(),
                                    ip.scale["w"]), want)
    assert qmm_ops.launches_by_variant["sm90"] == before + 1


# B4's two variants launched directly: M around the 16-row gemv
# threshold and the 64/128-row wgmma tiles, N around the 256-channel
# tile, K below, at and past the 4-stage ring of 128-code steps (4,112
# ends on a ragged step of 16)
QMM_VARIANT_M = (1, 4, 16, 17, 64, 65, 127, 128, 129, 300, 2048)
QMM_VARIANT_N = (8, 130, 256, 257, 4096)
QMM_VARIANT_K = (16, 144, 4096, 4112)


def _qmm_codes(M, K, N, dtype, device, seed):
    """Codes as the wrapper makes them: xq row-major from ``dtype``
    activations, wq K-major from ``quantize_params_int8``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=gen, device=device).to(dtype)
    ip = quantize_params_int8({"w": torch.randn(K, N, generator=gen,
                                                device=device)})
    xq, xs = quantize_act(x)
    return xq, xs.reshape(1), ip.q["w"], ip.scale["w"].reshape(-1)


def _qmm_variant_equals_plain(name, xq, xs, wq, ws):
    out = torch.full((xq.shape[0], wq.shape[1]), float("nan"),
                     device=xq.device)
    quant_matmul_cuda(xq, wq, xs, ws, out, variant=name)
    want = quant_matmul_ref(xq, wq, xs, ws)
    assert torch.equal(out, want), (out - want).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sm90", "gemv"])
@pytest.mark.parametrize("K", QMM_VARIANT_K)
@pytest.mark.parametrize("N", QMM_VARIANT_N)
@pytest.mark.parametrize("M", QMM_VARIANT_M)
def test_quant_matmul_variant_equals_plain(cuda, M, N, K, name, dtype):
    """Bit for bit, each variant at every shape, whichever the wrapper
    would route it to."""
    _qmm_variant_equals_plain(name, *_qmm_codes(M, K, N, dtype, cuda,
                                                M * 7 + N * 3 + K))


@pytest.mark.parametrize("name", ["sm90", "gemv"])
@pytest.mark.parametrize("M", [4, 2048])
@pytest.mark.parametrize("proj", ["up", "down"])
def test_quant_matmul_variant_equals_plain_at_yi9b(cuda, proj, M, name):
    """Yi-9B's MLP (d_model 4096, d_ff 11008): a decode tick and a
    prefill through each projection."""
    K, N = (4096, 11008) if proj == "up" else (11008, 4096)
    _qmm_variant_equals_plain(name, *_qmm_codes(M, K, N, torch.bfloat16,
                                                cuda, M + K))


@pytest.mark.parametrize("M,K,want", [(4, 4096, "gemv"), (16, 144, "gemv"),
                                      (17, 144, "sm90"), (2048, 4096, "sm90"),
                                      (300, 200, "sm90"), (4, 30, "gemv")])
def test_quant_matmul_wrapper_launches_the_routed_variant(cuda, M, K, want):
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, generator=gen, device=cuda, dtype=torch.bfloat16)
    ip = quantize_params_int8({"w": torch.randn(K, 257, generator=gen,
                                                device=cuda)})
    assert qmm_ops.variant(quantize_act(x)[0], ip.q["w"]) == want
    before = dict(qmm_ops.launches_by_variant)
    got = quant_matmul(x, ip.q["w"], ip.scale["w"])
    after = qmm_ops.launches_by_variant
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == want) for k in after}
    assert torch.equal(got, quant_matmul(x, ip.q["w"], ip.scale["w"],
                                         use_ref=True))


def test_carried_int8_codes_stay_k_major_on_the_card(cuda):
    """to_torch keeps the K-major strides of carried codes (stacked too),
    so the carried weights reach sm90 and gemv without a copy."""
    rng = np.random.default_rng(11)
    codes = rng.integers(-127, 128, (3, 64, 48)).astype(np.int8)
    k_major = np.ascontiguousarray(codes.swapaxes(-1, -2)).swapaxes(-1, -2)
    ip = to_torch(Int8Params(
        q={"w": k_major[0], "stack": k_major},
        scale={"w": np.full((1, 48), 0.01, np.float32),
               "stack": np.full((1, 1, 48), 0.02, np.float32)},
        skipped={"w": None, "stack": None}), device=cuda)
    assert ip.q["w"].is_cuda and ip.q["w"].stride() == (1, 64)
    assert ip.q["stack"].stride() == (64 * 48, 1, 64)
    assert torch.equal(ip.q["stack"].cpu(), torch.from_numpy(codes))
    x = torch.as_tensor(rng.standard_normal((4, 64)), dtype=torch.float32,
                        device=cuda)
    for wq, ws in ((ip.q["w"], ip.scale["w"]),
                   (ip.q["stack"][1], ip.scale["stack"][0])):
        assert qmm_ops.variant(quantize_act(x)[0], wq) == "gemv"
        assert torch.equal(quant_matmul(x, wq, ws),
                           quant_matmul(x, wq, ws, use_ref=True))


# (B, S, H, P, N, chunk): the reference's B6 test shapes, a ragged row block
# (chunk 96 = 64 + 32 rows), Zamba2's P = N = 64 at chunks 128 and 256,
# 4,096 steps at full head width (32 of the kernel's own 128-step chunks),
# and lengths that are no multiple of the kernel's chunk (caller chunks 40
# and 96)
SSD_SHAPES = [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 16, 16),
              (1, 192, 3, 16, 8, 96), (1, 512, 2, 64, 64, 128),
              (1, 512, 2, 64, 64, 256), (2, 40, 1, 5, 3, 128),
              (1, 4096, 2, 64, 64, 128), (1, 200, 2, 64, 64, 40),
              (1, 288, 3, 16, 8, 96)]


def _ssd_inputs(rng, B, S, H, P, N, with_h0, device, A_value=None):
    """tests/test_kernels.py::test_mamba2_kernel's distributions; A_value
    sets every head's A."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    x = t(rng.standard_normal((B, S, H, P)) * 0.5)
    dt = torch.nn.functional.softplus(t(rng.standard_normal((B, S, H))))
    A = -torch.exp(t(rng.standard_normal(H) * 0.3))
    if A_value is not None:
        A = torch.full_like(A, A_value)
    Bm = t(rng.standard_normal((B, S, 1, N)) * 0.5)
    Cm = t(rng.standard_normal((B, S, 1, N)) * 0.5)
    h0 = t(rng.standard_normal((B, H, P, N)) * 0.1) if with_h0 else None
    return x, dt, A, Bm, Cm, h0


def _hold(got, wants, bar=1e-4):
    for want in wants:
        for g, w in zip(got, want):
            assert (g.double() - w.double()).abs().max().item() < bar


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, with_h0):
    rng = np.random.default_rng(S + H + P + N)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, B, S, H, P, N, with_h0, cuda)
    before = ssd_ops.launches
    y, hf = ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    assert ssd_ops.launches == before + 1
    _hold((y, hf), (ssd_reference(x, dt, A, Bm, Cm, h0=h0),
                    ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h0)))


# decay extremes over two of the kernel's chunks: A = -20, where e^{a}
# underflows within a chunk, and A = -1e-4, the long memory where e^{a_tot}
# stays near 1 and y grows with the sequence. The plain version runs in
# f64 there: at the long memory its f32 run drifts from the f64 recurrence
# towards the bar and past it as the sequence grows (chip_smoke.py phase 11
# prints by how much), so the bar would read the yardstick's own rounding
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("A_value", [-20.0, -1e-4])
def test_ssd_kernel_decay_extremes(cuda, A_value, with_h0):
    rng = np.random.default_rng(17)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 1, 256, 2, 64, 64, with_h0, cuda,
                                       A_value)
    y, hf = ssd(x, dt, A, Bm, Cm, h0, chunk=128)
    f64 = [None if a is None else a.double() for a in (x, dt, A, Bm, Cm, h0)]
    _hold((y, hf), (ssd_reference(*f64[:5], h0=f64[5]),
                    ssd_chunked(x, dt, A, Bm, Cm, 128, h0=h0)))


# (B, S, H, N, chunk): the reference's B7 test shapes, RWKV6's N = 64,
# 4,096 steps at full head width (32 of the kernel's own 128-step chunks),
# and lengths that are no multiple of the kernel's chunk (caller chunks 48
# and 96)
WKV_SHAPES = [(2, 64, 3, 16, 32), (1, 128, 2, 32, 32), (2, 32, 4, 16, 32),
              (1, 256, 2, 64, 128), (1, 48, 1, 7, 16),
              (1, 4096, 2, 64, 128), (1, 240, 2, 64, 48),
              (1, 288, 3, 16, 96)]


def _wkv_inputs(rng, B, S, H, N, with_h0, device, w_value=None):
    """tests/test_kernels.py::test_wkv6_kernel's distributions; w_value sets
    every log-decay."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    r, k, v = (t(rng.standard_normal((B, S, H, N)) * 0.5) for _ in range(3))
    w_log = -torch.exp(t(rng.standard_normal((B, S, H, N)) * 0.5))
    if w_value is not None:
        w_log = torch.full_like(w_log, w_value)
    u = t(rng.standard_normal((H, N)) * 0.5)
    h0 = t(rng.standard_normal((B, H, N, N)) * 0.1) if with_h0 else None
    return r, k, v, w_log, u, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,N,chunk", WKV_SHAPES)
def test_wkv6_kernel_matches_plain(cuda, B, S, H, N, chunk, with_h0):
    rng = np.random.default_rng(S + H + N)
    r, k, v, w_log, u, h0 = _wkv_inputs(rng, B, S, H, N, with_h0, cuda)
    before = wkv_ops.launches
    y, hf = wkv6(r, k, v, w_log, u, h0, chunk=chunk)
    assert wkv_ops.launches == before + 1
    _hold((y, hf), (wkv6_reference(r, k, v, w_log, u, h0=h0),
                    wkv6_chunked(r, k, v, w_log, u, h0=h0, chunk=chunk)))


# decay extremes over two of the kernel's chunks: w_log = -30, where every
# step forgets the state, and -1e-4, the long memory; the plain version
# runs in f64, as for B6: its f32 run drifts further from the f64
# recurrence than B6's (chip_smoke.py phase 12 prints by how much)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("w_value", [-30.0, -1e-4])
def test_wkv6_kernel_decay_extremes(cuda, w_value, with_h0):
    rng = np.random.default_rng(19)
    r, k, v, w_log, u, h0 = _wkv_inputs(rng, 1, 256, 2, 64, with_h0, cuda,
                                        w_value)
    y, hf = wkv6(r, k, v, w_log, u, h0, chunk=128)
    f64 = [None if a is None else a.double() for a in (r, k, v, w_log, u, h0)]
    _hold((y, hf), (wkv6_reference(*f64[:5], h0=f64[5]),
                    wkv6_chunked(r, k, v, w_log, u, h0=h0, chunk=128)))


def test_ssd_and_wkv6_refuse_widths_the_kernels_lack(cuda):
    x = torch.zeros((1, 16, 1, 65), device=cuda)
    dt, A = torch.ones((1, 16, 1), device=cuda), -torch.ones(1, device=cuda)
    Bm = torch.zeros((1, 16, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="P, N <= 64"):
        ssd(x, dt, A, Bm, Bm, chunk=16)
    r = torch.zeros((1, 16, 1, 65), device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        wkv6(r, r, r, -torch.ones_like(r), torch.zeros((1, 65), device=cuda))


# --------------------------------------------------------------------------- #
# The verification half on the card
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_run_conformance_on_card(cuda, arch):
    """Golden set plus 4,096 seeded windows, no device given (CUDA): modes
    bit-exact, oracle 0 LSB, golden match; ``fused`` launches B1 once per
    cell and B2 once per linear/conv1d node, ``pallas`` B2 once per LSTM
    step and once per linear/conv1d node."""
    graph, _, _ = tvec.canonical_graph(arch)
    vs = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    e = graph.edges[graph.inputs[0]]
    extra = np.random.default_rng(13).integers(
        e.fmt.lo, e.fmt.hi + 1, (4096, *e.shape)).astype(np.int32)
    cells = [n for n in graph.nodes if n.op == "lstm_cell"]
    macs = sum(n.op in ("linear", "conv1d") for n in graph.nodes)
    b1, b2 = lstm_ops.launches, mac_ops.launches
    rep = run_conformance(graph, vs, extra_stimulus=extra)
    assert rep.passed, rep.to_json()
    assert rep.modes_bit_exact and rep.oracle_max_lsb == 0
    assert rep.golden_match is True and rep.n_vectors == 16 + 4096
    assert lstm_ops.launches - b1 == len(cells)
    assert mac_ops.launches - b2 == \
        2 * macs + sum(n.seq_len for n in cells)


@pytest.mark.parametrize("kind", ["act_apply", "act_lut", "conv1d",
                                  "elementwise", "linear", "lstm_cell"])
def test_fuzz_template_on_card(cuda, kind):
    for seed in (0, 1, 2):
        rep = fuzz_template(kind, seed=seed)
        if kind == "act_lut":
            assert rep is None
            continue
        assert rep.passed and rep.n_vectors == 24, rep.to_json()


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_emit_golden_on_card(cuda, arch, tmp_path):
    tvec.emit_golden(arch, str(tmp_path))
    for name in (tvec.VECTORS_NPZ, tvec.VECTORS_MANIFEST):
        want = open(os.path.join(GOLDEN_ROOT, arch, name), "rb").read()
        assert (tmp_path / arch / name).read_bytes() == want, name


@pytest.mark.parametrize("setting", ["fp32_precision", "allow_tf32"])
def test_oracle_codes_ignore_a_tf32_global(cuda, setting):
    """A linear layer with 14-bit input codes (more significant bits than
    TF32 keeps) inside the §4 envelope (|acc| < 2**22): with TF32 switched
    on globally the plain float oracle moves, ``oracle_codes`` does not —
    it equals the exact integer path — and the global is left as it was,
    whether it was set through the per-backend setting or the legacy
    flag."""
    in_fmt, w_fmt, out_fmt = FxpFormat(14, 8), FxpFormat(6, 4), \
        FxpFormat(16, 8)
    K, N = 16, 64
    rng = np.random.default_rng(23)
    g = Graph(name="tf32_probe")
    g.edges["x"] = Edge("x", (K,), in_fmt)
    g.inputs = ["x"]
    g.add(LinearNode(name="lin", op="linear", inputs=["x"], outputs=["y"],
                     weight=(rng.standard_normal((K, N)) * 0.6)
                     .astype(np.float32),
                     bias=(rng.standard_normal(N) * 0.1).astype(np.float32),
                     w_fmt=w_fmt, in_fmt=in_fmt, out_fmt=out_fmt),
          Edge("y", (N,), out_fmt))
    g.outputs = ["y"]
    x = rng.integers(in_fmt.lo, in_fmt.hi + 1, (8192, K)).astype(np.int32)
    exact = RTLEmulator(g, mode="jnp", device=cuda).run_int(x).outputs \
        .cpu().numpy().astype(np.int64)
    xf = x.astype(np.float32) / in_fmt.scale
    mm = torch.backends.cuda.matmul
    prev = getattr(mm, setting)
    setattr(mm, setting, "tf32" if setting == "fp32_precision" else True)
    try:
        got = oracle_codes(g, xf)
        loose = torch.round(reference_apply(g, xf) * out_fmt.scale) \
            .cpu().numpy().astype(np.int64)
        assert mm.fp32_precision == "tf32"
    finally:
        setattr(mm, setting, prev)
    np.testing.assert_array_equal(got, exact)
    assert not np.array_equal(loose, exact), \
        "TF32 did not move the unscoped oracle: this probe shows nothing"


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_canary_check_on_card(cuda, arch):
    graph, _, _ = tvec.canonical_graph(arch)
    vs = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    em = RTLEmulator(graph, device=cuda)
    res = canary_check(types.SimpleNamespace(emulator=em), vs, n=16)
    assert res.passed and res.path == "int" and res.n == 16
    res = canary_check(lambda x: reference_apply(graph, x), vs, n=16)
    assert res.passed and res.path == "float"
    name = next(n.name for n in graph.nodes if n.op in ("linear", "conv1d"))
    w = em.prepared(name)["w" if "w" in em.prepared(name) else "w_mat"]
    w.view(-1)[0] ^= 1 << 5
    assert not canary_check(types.SimpleNamespace(emulator=em), vs,
                            n=16).passed


# --------------------------------------------------------------------------- #
# Stage 1 and the paper's loop on the card
# --------------------------------------------------------------------------- #


def _traffic(device, batch=256):
    from repro_torch.data.pipeline import TrafficConfig, traffic_flow_batch

    return {k: torch.as_tensor(v, device=device) for k, v in
            traffic_flow_batch(TrafficConfig(batch=batch), 0).items()}


@pytest.mark.parametrize("qat", [True, False])
def test_window_loss_and_grads_card_vs_cpu(cuda, qat):
    """The QAT loss (hard activations, the workflow's) and the float window
    loss with their gradients, on the card against the CPU, within 1e-5:
    under QAT every gate product is a sum of grid values, exact in f32 on
    both devices, so only the batch reductions of the backward differ."""
    from repro_torch.model.layers import tree_leaves, value_and_grad
    from repro_torch.model.lm import make_loss_fn
    from repro_torch.quant.qat import QATConfig, make_qat_loss

    cfg = get_config("elastic-lstm")
    params = tvec.canonical_params(tvec.schema_for(cfg), seed=4)
    if qat:
        loss = make_qat_loss(cfg, QATConfig())
    else:
        loss = make_loss_fn(cfg, SMOKE_MESH, ParallelismConfig())
    out = {}
    for dev in ("cpu", cuda):
        (value, _), grads = value_and_grad(loss, has_aux=True)(
            to_torch(params, dev), _traffic(dev))
        out[str(dev)] = [value] + tree_leaves(grads)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert b.is_cuda and (a - b.cpu()).abs().max().item() <= 1e-5


def _deployment(arch, device=None):
    from repro_torch.rtl.backend import translate_rtl

    cfg = get_config(arch)
    params = tvec.canonical_params(tvec.schema_for(cfg))
    return translate_rtl(cfg, params, device=device)


def _flops(arch):
    from repro_torch.model.conv1d import conv1d_flops
    from repro_torch.model.lstm import lstm_flops

    cfg = get_config(arch)
    return float(lstm_flops(cfg) if cfg.family == "lstm"
                 else conv1d_flops(cfg))


def test_rtl_executable_measure_on_card(cuda):
    """``RTLExecutable.measure`` with no device given (CUDA): 20 timed runs,
    the warmup run outside the samples, B1 and B2 launched by every run."""
    from repro_torch.obs import MetricsRegistry, set_metrics

    syn, dep = _deployment("elastic-lstm")
    assert dep.device.type == "cuda"
    x = torch.zeros((8, 6, 1), device=cuda)
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    b1, b2 = lstm_ops.launches, mac_ops.launches
    try:
        rep = dep.measure((x,), model="elastic-lstm",
                          model_flops=_flops("elastic-lstm"))
    finally:
        set_metrics(prev)
    assert rep.n_runs == 20 and rep.latency_s == syn.est_latency_s
    assert reg.histogram("measure.latency_s.rtl").count == 20
    assert reg.counter("rtl.emulator.dispatch.fused").value == 21
    assert lstm_ops.launches - b1 == 21 and mac_ops.launches - b2 == 21
    assert 0 < rep.latency_p50_s <= rep.latency_p99_s


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_verify_deployment_on_card(cuda, arch):
    """``Deployment.verify`` of a CUDA RTLExecutable: conformance over the
    design's generated vectors on the card and the measurement protocol."""
    _, dep = _deployment(arch)
    b1, b2 = lstm_ops.launches, mac_ops.launches
    rep = dep.verify(model=arch, model_flops=_flops(arch))
    assert rep.passed, rep.to_json()
    assert rep.modes_bit_exact and rep.oracle_max_lsb == 0
    assert rep.protocol["passed"] and rep.protocol["n_runs"] == 20
    assert mac_ops.launches > b2
    assert (lstm_ops.launches > b1) == (arch == "elastic-lstm")


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_protocol_on_a_real_rtl_executable(cuda, arch):
    """The measurement protocol on a CUDA RTLExecutable in place of a stub
    deployment: the emulator runs, and the cycle model's latency, energy
    and (for Table I's design) the paper's bands all hold."""
    from repro_torch.verify import MeasurementProtocol, run_protocol

    _, dep = _deployment(arch)
    graph = tvec.canonical_graph(arch)[0]
    vs = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    b2 = mac_ops.launches
    rep = run_protocol(dep, (torch.as_tensor(vs.stimulus_f(), device=cuda),),
                       model=arch, model_flops=_flops(arch))
    assert rep.passed and rep.n_runs == 20 and rep.platform == \
        "rtl-emulator(xc7s15)"
    names = {c.name for c in rep.checks}
    assert {"latency_vs_cycle_model", "energy_vs_cycle_model"} <= names
    assert ("gop_per_j_vs_table1" in names) == (arch == "elastic-lstm")
    proto = MeasurementProtocol()              # warmup runs + timed runs
    assert mac_ops.launches - b2 == (proto.warmup + proto.n_runs) * sum(
        n.op in ("linear", "conv1d") for n in graph.nodes)


def test_workflow_run_once_on_card(cuda):
    """One trip around the loop on the card: Stage 1 trains there, the
    deployed design's emulator runs there, conformance passes."""
    from repro_torch.launch import elastic_workflow as ew
    from repro_torch.model.layers import tree_leaves

    wf = ew.build_workflow("elastic-lstm", verify=True, train_steps=3,
                           target="rtl")
    params, _, _ = wf.train_fn({"bits": 8, "frac": 6})
    assert all(p.is_cuda for p in tree_leaves(params))
    b1 = dict(lstm_ops.launches_by_variant)
    rec = wf.run_once({"bits": 12, "frac": 8})
    assert rec.conformance.passed and rec.analysis.passed
    assert lstm_ops.launches_by_variant["simt"] > b1["simt"]
    assert rec.synthesis.resources["cycles"] == 5237


# --------------------------------------------------------------------------- #
# The host target on the card
# --------------------------------------------------------------------------- #


def test_host_deployment_measures_on_card(cuda):
    """A host deployment with no device named runs on the card: its
    measurement synchronises every run and names the card."""
    from repro_torch.core.creator import Creator
    from repro_torch.core.types import SHAPES_LSTM
    from repro_torch.obs import MetricsRegistry, set_metrics

    cfg = get_config("elastic-lstm")
    cr = Creator()
    st = cr.build(cfg, SHAPES_LSTM["infer_1"])
    syn, dep = cr.translate(st)
    assert dep.device == cuda and dep.target == "xla"
    params = st.init()
    batch = {"x": torch.randn(1, 6, 1, device=cuda),
             "y": torch.zeros(1, 1, device=cuda)}
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        rep = dep.measure((params, batch), model=cfg.name,
                          model_flops=_flops("elastic-lstm"), warmup=2)
    finally:
        set_metrics(prev)
    assert rep.platform == torch.cuda.get_device_name(cuda)
    assert rep.n_runs == 20 and reg.histogram(
        "measure.latency_s.xla").count == 20
    assert 0 < rep.latency_p50_s <= rep.latency_p99_s
    pred, _ = dep(params, batch)
    assert pred.is_cuda and pred.shape == (1, 1)


def _yi_smoke_args(kind, device):
    from repro_torch.model.layers import tree_map

    yi = get_config("yi-9b", smoke=True)
    shape = ShapeConfig("s", kind, 128, 2)
    st = Stepper(yi, shape, SMOKE_MESH, ParallelismConfig(
        compute_dtype="bfloat16", attn_impl="flash"))
    params = st.init(device=device, dtype_override=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, yi.vocab_size, (2, 1 if kind == "decode"
                                              else 128), generator=gen,
                           dtype=torch.int32, device=device)
    if kind == "prefill":
        return st, (params, {"tokens": tokens})
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=device),
                     st.cache_schema(), is_leaf=lambda s: hasattr(s, "init"))
    return st, (params, tokens, cache)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_counts_on_card_equal_counts_on_meta(cuda, kind):
    from repro_torch.energy.cost import count_step
    from repro_torch.model.layers import tree_map

    st, args = _yi_smoke_args(kind, cuda)
    fn = st.prefill_fn() if kind == "prefill" else st.decode_fn()
    with torch.inference_mode():
        on_card = count_step(fn, args)
        on_meta = count_step(fn, tree_map(lambda t: t.to("meta"), args))
    assert on_card == on_meta


def test_deployed_smoke_prefill_launches_b5_once_a_layer(cuda):
    from repro_torch.core.creator import Creator

    st, args = _yi_smoke_args("prefill", cuda)
    syn, dep = Creator().translate(st, params=args[0])
    assert dep.ops_text.count("flash_attention") == st.cfg.n_layers
    before = dict(flash_ops.launches_by_variant)
    logits, cache = dep(*args)
    torch.cuda.synchronize()
    assert flash_ops.launches_by_variant["sm90"] - before["sm90"] == \
        st.cfg.n_layers
    assert flash_ops.launches_by_variant["simt"] == before["simt"]
    assert torch.isfinite(logits).all() and logits.shape == (
        2, st.cfg.padded_vocab)


# --------------------------------------------------------------------------- #
# the program cache on the card: CUDA Graphs of the emulator's walk
# --------------------------------------------------------------------------- #


def _launch_counts():
    return {"B1": lstm_ops.launches, "B2": mac_ops.launches,
            **{f"B1.{k}": v for k, v in lstm_ops.launches_by_variant.items()}}


def _per_run_launches(graph, mode):
    """What one run of the walk launches in ``mode``."""
    cells = [n for n in graph.nodes if n.op == "lstm_cell"]
    macs = sum(n.op in ("linear", "conv1d") for n in graph.nodes)
    if mode == "jnp":
        return {"B1": 0, "B2": 0}
    if mode == "pallas":
        return {"B1": 0, "B2": macs + sum(n.seq_len for n in cells)}
    return {"B1": len(cells), "B2": macs}


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
@pytest.mark.parametrize("mode", RTLEmulator.MODES)
def test_replayed_program_equals_the_eager_jnp_walk(cuda, arch, mode):
    """Each program is one CUDA Graph: the first call builds it (warm-up +
    capture, one trace), later calls replay it, equal to the eager plain
    walk integer for integer, edge for edge; the launch counters grow on
    every replay by the walk's launches; a result survives the next call."""
    from repro_torch.rtl.cuda_graph import CapturedProgram

    graph, _, _ = tvec.canonical_graph(arch)
    rng = np.random.default_rng(3)
    fmt = graph.edges["x"].fmt
    xs = [rng.integers(fmt.lo, fmt.hi + 1, (4099, *graph.edges["x"].shape))
          .astype(np.int32) for _ in range(3)]
    em = RTLEmulator(graph, mode=mode, device=cuda)
    plain = RTLEmulator(graph, mode="jnp", device=cuda)
    before = _launch_counts()
    first = em.run_int(xs[0])
    torch.cuda.synchronize()
    built = {k: _launch_counts()[k] - before[k] for k in ("B1", "B2")}
    assert built == _per_run_launches(graph, mode)   # the warm-up run only
    assert em.trace_count == 1 and em.has_program(xs[0].shape, np.int32)
    prog = em._programs._programs[em._cache_key(xs[0].shape, torch.int32)]
    assert isinstance(prog, CapturedProgram)
    assert isinstance(prog.graph, torch.cuda.CUDAGraph)
    kept = {k: v.clone() for k, v in first.trace.items()}
    for x in xs[1:]:
        before = _launch_counts()
        got = em.run_int(x)
        torch.cuda.synchronize()
        grew = {k: _launch_counts()[k] - before[k] for k in ("B1", "B2")}
        assert grew == _per_run_launches(graph, mode)
        want = plain.run_int_per_step(x)              # eager, no program
        assert sorted(got.trace) == sorted(want.trace)
        for k in want.trace:
            assert torch.equal(got.trace[k], want.trace[k]), k
        assert torch.equal(got.outputs_f, want.outputs_f)
    assert em.trace_count == 1 and em.cache_stats()["hits"] == 2
    for k, v in kept.items():
        assert torch.equal(first.trace[k], v), k


def test_replay_counts_b1_by_variant(cuda):
    """A 12-bit twin routes to simt: replays count simt, never mma."""
    graph, _, _ = tvec.canonical_graph("elastic-lstm",
                                       act_fmt=FxpFormat(12, 6),
                                       state_fmt=FxpFormat(12, 8))
    x = np.random.default_rng(4).standard_normal(
        (1000, *graph.edges["x"].shape)).astype(np.float32)
    em = RTLEmulator(graph, device=cuda)
    em.run(x)
    lstm_ops.launches_by_variant = dict.fromkeys(
        lstm_ops.launches_by_variant, 0)
    for _ in range(3):
        em.run(x)
    torch.cuda.synchronize()
    assert lstm_ops.launches_by_variant == {"mma": 0, "simt": 3}


def test_isomorphic_siblings_replay_one_graph_with_their_own_params(cuda):
    from repro_torch.rtl.program_cache import ProgramLRU

    lru = ProgramLRU(4)
    graphs = [tvec.canonical_graph("elastic-lstm", seed=s)[0]
              for s in (0, 1, 2)]
    ems = [RTLEmulator(g, programs=lru, device=cuda) for g in graphs]
    x = np.random.default_rng(5).integers(
        -128, 128, (777, 6, 1)).astype(np.int32)
    for _ in range(2):                   # 2nd round: params reload each hop
        for g, em in zip(graphs, ems):
            want = RTLEmulator(g, mode="jnp", device=cuda) \
                .run_int_per_step(x).outputs
            assert torch.equal(em.run_int(x).outputs, want)
    assert sum(em.trace_count for em in ems) == 1
    assert lru.stats() == {"hits": 5, "misses": 1, "evictions": 0,
                           "size": 1}


def test_a_param_written_in_place_reaches_the_next_replay(cuda):
    graph, _, _ = tvec.canonical_graph("elastic-conv1d")
    em = RTLEmulator(graph, device=cuda)
    x = np.random.default_rng(6).integers(
        -128, 128, (64, *graph.edges["x"].shape)).astype(np.int32)
    base = em.run_int(x).outputs.clone()
    assert torch.equal(em.run_int(x).outputs, base)          # a replay
    em.prepared("linear_head")["w"].view(-1)[0] += 3
    moved = em.run_int(x).outputs
    want = RTLEmulator(graph, device=cuda)
    want.prepared("linear_head")["w"].view(-1)[0] += 3
    assert torch.equal(moved, want.run_int_per_step(x).outputs)
    assert not torch.equal(moved, base) and em.trace_count == 1


def test_eviction_and_clear_free_the_graphs(cuda):
    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, max_programs=2, device=cuda)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    for b in (30000, 30001, 30002, 30003):
        em.run_int(np.zeros((b, 6, 1), np.int32))
    torch.cuda.synchronize()
    two = torch.cuda.memory_allocated() - start
    assert em.cache_evictions == 2 and len(em._programs) == 2
    em._programs.clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - start < two / 4


def test_a_capture_that_fails_raises_and_caches_nothing(cuda, monkeypatch):
    """A walk that syncs cannot be captured: the build raises, nothing is
    cached, and nothing runs the eager walk in its place."""
    from repro_torch.rtl.oplib import get_template

    graph, _, _ = tvec.canonical_graph("elastic-conv1d")
    tmpl = get_template("linear")
    execute = tmpl.execute

    def syncing(n, env, em, mode):
        execute(n, env, em, mode)
        env[n.outputs[0]].sum().item()           # a device->host read

    em = RTLEmulator(graph, device=cuda)
    x = np.zeros((8, *graph.edges["x"].shape), np.int32)
    monkeypatch.setattr(tmpl, "execute", syncing)
    with pytest.raises(RuntimeError):
        em.run_int(x)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert not em.has_program(x.shape, np.int32)
    assert len(em._programs) == 0 and em.cache_misses == 0
    assert torch.equal(em.run_int(x).outputs,
                       RTLEmulator(graph, mode="jnp", device=cuda)
                       .run_int_per_step(x).outputs)


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_multi_design_replay_equals_sequential_and_jnp(cuda, arch):
    from repro_torch.rtl.multi import MultiDesignEmulator

    graphs = [tvec.canonical_graph(arch, seed=s)[0] for s in range(4)]
    multi = MultiDesignEmulator(graphs, device=cuda)
    fmt = graphs[0].edges["x"].fmt
    rng = np.random.default_rng(8)
    x = rng.integers(fmt.lo, fmt.hi + 1,
                     (2048, *graphs[0].edges["x"].shape)).astype(np.int32)
    multi.run_int(x)                                     # build
    before = _launch_counts()
    got = multi.run_int(x)                               # one replay
    torch.cuda.synchronize()
    grew = {k: _launch_counts()[k] - before[k] for k in ("B1", "B2")}
    assert grew == {k: 4 * n for k, n in
                    _per_run_launches(graphs[0], "fused").items()}
    assert multi.trace_count == 1
    seq = multi.run_int_sequential(x)
    np.testing.assert_array_equal(got.outputs.cpu().numpy(), seq)
    for k, g in enumerate(graphs):
        want = RTLEmulator(g, mode="jnp", device=cuda).run_int_per_step(x)
        assert torch.equal(got.outputs[k], want.outputs), k
    xs = np.stack([x + 0 * k for k in range(4)])
    xs[1] = np.roll(x, 1, axis=0)
    per = multi.run_int(xs, per_design=True).outputs
    for k, em in enumerate(multi.emulators):
        assert torch.equal(per[k], em.run_int(xs[k]).outputs), k


def test_sharded_executable_on_the_cards_devices(cuda):
    import dataclasses

    from repro_torch.rtl.backend import translate_rtl
    from repro_torch.serving import ShardedExecutable, make_serving_mesh

    cfg = get_config("elastic-lstm")
    _, exe = translate_rtl(cfg, tvec.canonical_params(tvec.schema_for(cfg)),
                           device=cuda)
    mesh = make_serving_mesh()
    assert mesh == [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    sharded = ShardedExecutable(dataclasses.replace(exe), mesh)
    x = np.random.default_rng(9).standard_normal(
        (1001, 6, 1)).astype(np.float32)
    for _ in range(2):
        assert torch.equal(sharded(x), exe(x))
    assert sharded.holds_program(x.shape, x.dtype)
    assert all(em.trace_count == 1 for em in sharded.emulators)


def test_holds_program_turns_true_after_the_first_call(cuda):
    import dataclasses

    from repro_torch.rtl.backend import translate_rtl

    cfg = get_config("elastic-conv1d")
    _, exe = translate_rtl(cfg, tvec.canonical_params(tvec.schema_for(cfg)),
                           device=cuda)
    replica = dataclasses.replace(exe)
    assert replica.emulator is not exe.emulator
    x = np.zeros((32, 16, 3), np.float32)
    assert not replica.holds_program(x.shape, x.dtype)
    replica(x)
    assert replica.holds_program(x.shape, x.dtype)
    assert not exe.holds_program(x.shape, x.dtype)


def test_farm_on_the_card_is_bit_exact_per_request(cuda):
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import FarmConfig, pad_window
    from repro_torch.serving import loadgen

    farm, pools = loadgen.build_farm(
        ("lstm", "conv1d"), replicas=2, cfg=FarmConfig(max_batch=16),
        metrics=MetricsRegistry(), device=cuda)
    spec = loadgen.TrafficSpec(n_requests=200, wave=50, seed=2)
    rep = loadgen.run_loadgen(farm, pools, spec)
    assert rep["by_status"] == {"done": 200}
    by_family = {p.family: p for p in pools}
    for req in list(farm.requests.values())[::7]:
        member = by_family[req.design].members[req.bucket_len][req.member]
        solo = RTLEmulator(member.graph, mode="jnp", device=cuda).run(
            pad_window(req.window, req.bucket_len)[None]).outputs_f
        np.testing.assert_array_equal(req.result, solo.cpu().numpy()[0])


def test_one_program_serves_8_threads_on_the_card(cuda):
    """Threads share one emulator and its CUDA Graph (farm workers): the
    program's lock keeps copy-in, replay and copy-out together, so every
    thread's answers equal its own solo runs."""
    import sys
    import threading

    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, device=cuda)
    rng = np.random.default_rng(12)
    xs = [rng.integers(-128, 128, (512, 6, 1)).astype(np.int32)
          for _ in range(8)]
    want = [RTLEmulator(graph, mode="jnp", device=cuda)
            .run_int_per_step(x).outputs for x in xs]
    em.run_int(xs[0])                                    # build
    errors = []

    def serve(i):
        try:
            for _ in range(20):
                assert torch.equal(em.run_int(xs[i]).outputs, want[i])
        except Exception as e:                           # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and em.trace_count == 1


# --------------------------------------------------------------------------- #
# The resilience layer on the card: B1 after a flipped W (a bit of a word
# leaves w_fmt), replays after flips, an SEU sweep and the acceptance
# scenario
# --------------------------------------------------------------------------- #


def _b1_by_variant():
    return dict(lstm_ops.launches_by_variant)


def _grew(before):
    return {k: lstm_ops.launches_by_variant[k] - before[k] for k in before}


def test_b1_with_table_i_w_flipped_at_bit_7_equals_plain(cuda):
    """Table I's cell with W word 0 set to ``w0 ^ 128`` (outside Q8.6):
    the wrapper launches simt and equals the plain version; restored, it
    launches mma again."""
    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, device=cuda)
    p = em.prepared("lstm_cell_l0")
    luts = (em.prepared("hard_sigmoid_lut")["table"],
            em.prepared("hard_tanh_lut")["table"])
    x = _codes(np.random.default_rng(11), A, (4096, 6, 1), cuda)
    w = p["w"].clone()
    w0 = int(w.view(-1)[0])
    w.view(-1)[0] = w0 ^ 128
    args = (x, w, p["b"], *luts)
    before = _b1_by_variant()
    got = lstm_window_int(*args, spec=p["spec"])
    assert _grew(before) == {"mma": 0, "simt": 1}
    assert torch.equal(got, lstm_window_int_ref(*args, spec=p["spec"]))
    w.view(-1)[0] = w0
    before = _b1_by_variant()
    assert torch.equal(lstm_window_int(*args, spec=p["spec"]),
                       lstm_window_int_ref(*args, spec=p["spec"]))
    assert _grew(before) == {"mma": 1, "simt": 0}
    torch.cuda.synchronize()


def test_replay_after_a_flip_matches_the_jnp_walk(cuda):
    """A flip drops the programs; the next run builds one for the cell's
    new variant (simt) and its replays equal the jnp walk flipped the same
    way; the second flip restores mma and the first answers."""
    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, device=cuda)
    plain = RTLEmulator(graph, mode="jnp", device=cuda)
    x = _codes(np.random.default_rng(12), A, (5000, 6, 1), cuda)
    base = em.run_int(x).outputs.clone()
    for step, want_variant in ((1, "simt"), (2, "mma")):
        em.flip_bit("lstm_cell_l0", "w", 0, 7)
        plain.flip_bit("lstm_cell_l0", "w", 0, 7)
        assert em._b1_variants == (want_variant,)
        want = plain.run_int_per_step(x).outputs
        em.run_int(x)                                  # builds
        before = _b1_by_variant()
        got = em.run_int(x).outputs                    # replays
        torch.cuda.synchronize()
        assert _grew(before) == {"mma": int(want_variant == "mma"),
                                 "simt": int(want_variant == "simt")}
        assert torch.equal(got, want)
        assert torch.equal(got, base) == (step == 2)
    assert em.trace_count == 3 and em.seu_flips == 2


def test_siblings_sharing_an_lru_with_one_flipped_on_card(cuda):
    """No replay loads a W outside w_fmt into an mma program: a flipped
    sibling gets its own (simt) program, and both stay bit-exact."""
    from repro_torch.rtl.program_cache import ProgramLRU

    lru = ProgramLRU(4)
    graphs = [tvec.canonical_graph("elastic-lstm", seed=s)[0]
              for s in (0, 1)]
    ems = [RTLEmulator(g, programs=lru, device=cuda) for g in graphs]
    plains = [RTLEmulator(g, mode="jnp", device=cuda) for g in graphs]
    x = _codes(np.random.default_rng(13), A, (777, 6, 1), cuda)
    for em in ems:
        em.run_int(x)
    ems[1].flip_bit("lstm_cell_l0", "w", 0, 7)
    plains[1].flip_bit("lstm_cell_l0", "w", 0, 7)
    for _ in range(2):
        for em, plain in zip(ems, plains):
            assert torch.equal(em.run_int(x).outputs,
                               plain.run_int_per_step(x).outputs)
    torch.cuda.synchronize()
    assert lru.stats()["misses"] == 3 and len(lru) == 2


SEU_BITS = (0, 7, 15, 30, 31)


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-lstm-q12",
                                  "elastic-conv1d"])
def test_seu_sweep_on_card(cuda, arch):
    """Every memory, bits 0/7/15/30/31 of a seeded word, 4,096 windows:
    the fused walk (kernels, CUDA Graph replays) equals the card's jnp
    walk and, on the first 1,024 windows, a CPU emulator flipped the same
    way; B1 goes simt exactly while a W word is outside w_fmt; the card
    ends with a clean synchronize (no trap)."""
    kw = dict(act_fmt=FxpFormat(12, 6), state_fmt=FxpFormat(12, 8)) \
        if arch.endswith("q12") else {}
    graph, _, _ = tvec.canonical_graph(arch.replace("-q12", ""), **kw)
    fused = RTLEmulator(graph, device=cuda)
    plain = RTLEmulator(graph, mode="jnp", device=cuda)
    host = RTLEmulator(graph, device="cpu")
    fmt = graph.edges[graph.inputs[0]].fmt
    x = _codes(np.random.default_rng(14), fmt,
               (4096, *graph.edges[graph.inputs[0]].shape), cuda)
    base = fused.run_int(x).outputs.clone()
    rng = np.random.default_rng(15)
    for node, key in fused.memories():
        word = int(rng.integers(fused.prepared(node)[key].numel()))
        for bit in SEU_BITS:
            new = fused.flip_bit(node, key, word, bit)
            assert plain.flip_bit(node, key, word, bit) == new
            assert host.flip_bit(node, key, word, bit) == new
            spec = fused.prepared(node).get("spec")
            if key == "w" and spec is not None:
                fmt_w = spec.w_fmt
                outside = not fmt_w.lo <= new <= fmt_w.hi
                mma = lstm_ops.variant(spec) == "mma"
                assert fused._b1_variants == (
                    ("simt" if outside or not mma else "mma"),)
            got = fused.run_int(x).outputs
            assert torch.equal(got, plain.run_int(x).outputs), \
                (node, key, bit)
            assert torch.equal(got[:1024].cpu(),
                               host.run_int(x[:1024].cpu()).outputs)
            for em in (fused, plain, host):
                em.flip_bit(node, key, word, bit)
    assert torch.equal(fused.run_int(x).outputs, base)
    torch.cuda.synchronize()


def test_acceptance_scenario_on_card_equals_the_cpus(cuda):
    """examples/chaos_plan.json, 24 requests, seed 7, the reference test's
    guard policy, the float-oracle "xla" fallback on the card: the
    scenario passes, and its JSON equals the CPU's byte for byte."""
    from repro_torch.core.workflow import chaos_fallback
    from repro_torch.energy.hw import XC7S15
    from repro_torch.resilience import (ChaosSpec, FaultPlan, GuardPolicy,
                                        run_chaos)
    from repro_torch.rtl.backend import RTLExecutable

    plan = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples", "chaos_plan.json")
    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    texts = []
    for device in (cuda, "cpu"):
        dep = RTLExecutable(graph=graph, artifacts={}, hw=XC7S15,
                            device=device)
        spec = ChaosSpec(plan=FaultPlan.load(plan), n_requests=24, seed=7,
                         policy=GuardPolicy(timeout_s=0.25, max_retries=2,
                                            breaker_threshold=3,
                                            canary_every=4))
        rep = run_chaos(dep, spec, fallback=chaos_fallback(dep, XC7S15))
        assert rep.passed and rep.requests_lost == 0, rep.summary()
        texts.append(rep.to_json())
    assert texts[0] == texts[1]
    torch.cuda.synchronize()


def test_guarded_farm_on_card_routes_around_the_flipped_replica(cuda):
    """Two guarded replicas with a canary; the busy one is flipped
    mid-pass: its canary quarantines it, the router sends it nothing after
    that, nothing fails, and the answers after detection equal per-request
    jnp runs."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.resilience import GuardedDeployment, GuardPolicy
    from repro_torch.rtl.backend import RTLExecutable
    from repro_torch.serving import (AcceleratorFarm, DesignPool,
                                     FarmConfig, pad_window)
    from repro_torch.energy.hw import XC7S15

    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    vectors = tvec.generate_vectors(graph, device=cuda)
    members = [RTLExecutable(graph=graph, artifacts={}, hw=XC7S15,
                             device=cuda).guarded(
        canary=vectors, policy=GuardPolicy(canary_every=4, max_retries=0),
        rng=np.random.default_rng(0), metrics=MetricsRegistry(),
        name=f"r{i}") for i in range(2)]
    farm = AcceleratorFarm([DesignPool(family="lstm",
                                       members={6: members})],
                           FarmConfig(max_batch=8))
    rng = np.random.default_rng(16)
    rids = []
    for wave in range(8):
        rids += [farm.submit("lstm", rng.standard_normal(
            (int(t), 1)).astype(np.float32))
            for t in rng.integers(1, 7, size=32)]
        if wave == 2:
            busy = max(range(2), key=lambda i: members[i].calls)
            members[busy].emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
        farm.tick(flush=True)
    st = farm.run_until_drained()
    assert st.failed == 0 and st.admitted == st.done + st.expired
    assert members[busy].quarantined and not members[1 - busy].quarantined
    calls_at = members[busy].detections[0]["call"]
    assert members[busy].calls == calls_at
    plain = RTLEmulator(graph, mode="jnp", device=cuda)
    late = [farm.result(r) for r in rids[4 * 32:]]
    for req in late:
        assert req.member == 1 - busy
        solo = plain.run(pad_window(req.window, 6)[None])
        assert np.array_equal(req.result, solo.outputs_f.cpu().numpy()[0])
    torch.cuda.synchronize()


def test_flips_under_concurrent_replays_on_card(cuda):
    """Threads replay one emulator's program while another flips W's bit
    7 back and forth (mma <-> simt): every answer is the unflipped or the
    flipped design's, nothing raises, and the card synchronises clean (no
    replay loaded a flipped W into an mma program)."""
    import sys
    import threading

    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, device=cuda)
    x = _codes(np.random.default_rng(17), A, (4096, 6, 1), cuda)
    want = [em.run_int(x).outputs.clone()]
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    want.append(em.run_int(x).outputs.clone())
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    bad, errors, stop = [], [], threading.Event()

    def run():
        try:
            while not stop.is_set():
                got = em.run_int(x).outputs
                if not any(torch.equal(got, w) for w in want):
                    bad.append(got.cpu())
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    def flip():
        try:
            for _ in range(40):
                em.flip_bit("lstm_cell_l0", "w", 0, 7)
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runners = [threading.Thread(target=run) for _ in range(6)]
        flipper = threading.Thread(target=flip)
        for t in runners + [flipper]:
            t.start()
        flipper.join(timeout=120)
        stop.set()
        for t in runners:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    torch.cuda.synchronize()
    assert not flipper.is_alive() and not any(t.is_alive() for t in runners)
    assert errors == [] and bad == []
    assert torch.equal(em.run_int(x).outputs, want[0])


@pytest.mark.parametrize("block", range(4))
def test_flips_under_concurrent_replays_repeated_in_one_process(cuda, block):
    """The test above 60 times in a row in one process, four blocks (ROADMAP
    §C7: the capture race showed in such loops, not in one run a
    process). Every run passes, and no device memory stays allocated
    after a block: each run's programs go with its emulator. The blocks
    no longer return the dropped CUDA Graph pools themselves: the next
    capture does (ROADMAP §C10)."""
    import gc

    base = torch.cuda.memory_allocated(cuda)
    for _ in range(60):
        test_flips_under_concurrent_replays_on_card(cuda)
        gc.collect()
    assert torch.cuda.memory_allocated(cuda) <= base


def test_flips_under_concurrent_replays_300_times_keep_reserved_memory(cuda):
    """ROADMAP §C10: the test above 300 times in one process, with no
    ``torch.cuda.empty_cache()`` of its own. Every run passes, and the
    caching allocator's reserved memory after run 300 lies within 2 GB of
    its reading after run 30: each capture that follows a dropped program
    returns the dropped pools (``rtl/cuda_graph.py::capturing``). Before
    the repair it climbed about 0.35 GB a run and ran out near run 240."""
    import gc

    reserved = {}
    for run in range(1, 301):
        test_flips_under_concurrent_replays_on_card(cuda)
        gc.collect()
        if run in (30, 300):
            reserved[run] = torch.cuda.memory_reserved(cuda)
    assert reserved[300] - reserved[30] <= 2e9, reserved


# --------------------------------------------------------------------------- #
# LM training on the card: B5's gradient, the train step, recovery,
# checkpoints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "sm90"),
                                        (torch.float32, "simt")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_on_card_is_the_plain_versions(cuda, dtype, name,
                                                      causal):
    """B5's backward is the plain version's VJP recomputed from (q, k, v):
    dq, dk, dv equal those through ``attention_ref`` bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    q, k, v, dout = (torch.randn((2, 200, 3, 80), generator=gen,
                                 device=cuda).mul(0.5).to(dtype)
                     for _ in range(4))

    def grads(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*qkv, causal), qkv, dout)

    before = dict(flash_ops.launches_by_variant)
    got = grads(flash_attention)
    assert flash_ops.launches_by_variant[name] == before[name] + 1
    for g, w in zip(got, grads(attention_ref)):
        assert g.dtype == dtype and torch.equal(g, w)


def _train_case(cuda, arch="yi-9b", dtype="float32"):
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model.lm import Stepper

    cfg = get_config(arch, smoke=True)
    st = Stepper(cfg, ShapeConfig("t", "train", 32, 8), SMOKE_MESH,
                 ParallelismConfig(compute_dtype=dtype, attn_impl="flash"))
    batch = lm_batch_for_step(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=32, global_batch=8), 0)
    return cfg, st, batch


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 train step from the same params on the card and on the
    CPU: B5 launched twice a layer (a forward and its remat recompute),
    loss, gnorm and the new params within 1e-5."""
    from repro_torch.model.layers import tree_leaves
    from repro_torch.optim.adamw import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, st, batch = _train_case(cuda)
    params = st.init(seed=1, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = to_torch(params, device=dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = flash_ops.launches
        out[str(dev)] = st.train_fn()(p, init_opt_state(p), b)
        launched = flash_ops.launches - before
        assert launched == (2 * cfg.n_layers if dev == cuda else 0)
    (pc, _, mc), (pg, _, mg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "gnorm"):
        assert abs(mg[key].item() - mc[key].item()) <= 1e-5 * abs(
            mc[key].item())
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        assert (a.cpu() - b).abs().max().item() <= 1e-5


def test_donating_update_on_card_is_bit_for_bit(cuda):
    from repro_torch.model.layers import tree_leaves, tree_map
    from repro_torch.optim import adamw

    gen = torch.Generator(device=cuda).manual_seed(3)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    for dtype in (torch.float32, torch.bfloat16):
        params = {"w": torch.randn((64, 33), generator=gen,
                                   device=cuda).to(dtype),
                  "b": torch.randn((33,), generator=gen,
                                   device=cuda).to(dtype)}
        opt = adamw.init_opt_state(params)
        p2, o2 = tree_map(torch.clone, params), tree_map(torch.clone, opt)
        for _ in range(3):
            grads = tree_map(lambda t: torch.randn(
                t.shape, generator=gen, device=cuda).to(dtype), params)
            params, opt, info = adamw.adamw_update(grads, opt, params, cfg)
            p2, o2, info2 = adamw.adamw_update_(
                tree_map(torch.clone, grads), o2, p2, cfg)
            for a, b in zip(tree_leaves((params, opt, info)),
                            tree_leaves((p2, o2, info2))):
                assert torch.equal(a, b)


def test_recovery_on_card(cuda, tmp_path):
    """The reference's recovery scenario, shortened: a preemption at step
    5 of 9, checkpoints every 3 steps; the replay logs the clean run's
    losses within 1e-4."""
    from repro_torch.data.pipeline import LMDataConfig
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    cfg, st, _ = _train_case(cuda)

    def run(td, inj=None):
        return Trainer(st, LMDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=8, seed=7),
                       TrainerConfig(total_steps=9, ckpt_every=3,
                                     ckpt_dir=str(td), log_every=1),
                       injector=inj, device=cuda).train()

    hit = run(tmp_path / "a", FailureInjector(fail_at_steps={5}))
    clean = run(tmp_path / "b")
    assert hit["recoveries"] == 1 and hit["steps"] == 9
    for a, b in zip(hit["metrics"][-4:], clean["metrics"][-4:]):
        assert a["step"] == b["step"] and abs(a["loss"] - b["loss"]) < 1e-4


def test_cpu_checkpoint_restores_onto_card_bit_for_bit(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.model.layers import tree_leaves, tree_map
    from repro_torch.optim.adamw import init_opt_state

    _, st, _ = _train_case(cuda)
    params = st.init(seed=2, device="cpu", dtype_override=torch.bfloat16)
    state = {"params": params, "opt": init_opt_state(params)}
    save_checkpoint(str(tmp_path), 4, state)
    back = load_checkpoint(str(tmp_path), 4,
                           tree_map(lambda t: torch.zeros_like(
                               t, device=cuda), state))
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


# --------------------------------------------------------------------------- #
# The LM families: MoE, cross-attention
# --------------------------------------------------------------------------- #


def _moe_case(arch, seed=3):
    from repro_torch.model.layers import tree_map

    cfg = get_config(arch, smoke=True)
    params = Stepper(cfg, ShapeConfig("p", "prefill", 16, 1), SMOKE_MESH,
                     ParallelismConfig(compute_dtype="float32")).init(
                         seed=seed, device="cpu")
    gi = 1 if cfg.moe.first_dense else 0
    return cfg, tree_map(lambda a: a[0], params[f"g{gi}"]["moe"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_moe_dense_on_card_matches_cpu(cuda, arch):
    """The dense oracle (every impl with no mesh) in f32 on the card and
    on the CPU from one set of params: router ids equal, outputs within
    1e-5, aux within 1e-6 relative."""
    from repro_torch.model import moe
    from repro_torch.model.layers import Ctx, tree_map
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg, p = _moe_case(arch)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    ctx = Ctx(cfg, SMOKE_MESH, "prefill",
              par=ParallelismConfig(compute_dtype="float32"))
    want = moe.moe_apply(p, x, cfg, ctx)
    ids = moe._router(p, x.reshape(-1, cfg.d_model), cfg.moe)[1]
    with exact_f32_matmul():
        got = moe.moe_apply(tree_map(lambda t: t.to(cuda), p), x.to(cuda),
                            cfg, ctx)
        got_ids = moe._router({"router": p["router"].to(cuda)},
                              x.to(cuda).reshape(-1, cfg.d_model),
                              cfg.moe)[1]
    assert torch.equal(got_ids.cpu(), ids)
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-5
    assert abs(got[1].item() - want[1].item()) <= 1e-6 * abs(want[1].item())


def test_router_tie_rule_on_card(cuda):
    """Lowest expert index first among equal probabilities, on the card
    as on the CPU."""
    from repro_torch.core.types import MoEConfig
    from repro_torch.model import moe

    m = MoEConfig(n_experts=64, top_k=6, d_expert=8)
    router = torch.zeros((4, 64), device=cuda)
    router[:, 10] = 0.5
    x = torch.ones((3, 4), device=cuda)
    assert moe._router({"router": router}, x, m)[1].tolist() == \
        [[10, 0, 1, 2, 3, 4]] * 3
    probs = torch.tensor([[.15] * 4 + [.14] * 4 + [.005] * 4], device=cuda)
    assert moe.top_k(probs, 6)[1].tolist() == [[0, 1, 2, 3, 4, 5]]


def test_deepseek_moe_layer_full_width_flash_vs_plain(cuda):
    """One DeepSeek-MoE-16B MoE layer at full width (64 experts, 2 shared,
    hd 128) over 1,024 positions in bf16: B5 (``sm90``) against plain
    attention within 2^-7 relative rms (phase 7's bar at one layer), the
    aux loss within 1e-3 relative."""
    from repro_torch.model.layers import Ctx, init_params
    from repro_torch.model.transformer import _apply_moe_block, block_schema

    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = init_params(block_schema(cfg, "moe"), gen,
                    dtype_override=torch.bfloat16)
    assert p["moe"]["router"].dtype == torch.float32
    x = (torch.randn((1, 1024, cfg.d_model), generator=gen, device=cuda)
         ).to(torch.bfloat16)
    pos = torch.arange(1024, device=cuda)[None]
    out = {}
    for impl in ("flash", "ref"):
        ctx = Ctx(cfg, SMOKE_MESH, "prefill", par=ParallelismConfig(
            compute_dtype="bfloat16", attn_impl=impl), positions=pos,
            attn_impl=impl)
        before = dict(flash_ops.launches_by_variant)
        with torch.no_grad():
            out[impl] = _apply_moe_block(p, x, ctx, None)
        torch.cuda.synchronize()
        launched = {k: flash_ops.launches_by_variant[k] - before[k]
                    for k in before}
        assert launched == ({"sm90": 1, "simt": 0} if impl == "flash"
                            else {"sm90": 0, "simt": 0})
    (yf, _, af), (yr, _, ar) = out["flash"], out["ref"]
    assert torch.isfinite(yf).all()
    rel = ((yf.float() - yr.float()).norm() / yr.float().norm()).item()
    assert rel <= 2.0 ** -7, rel
    assert abs(af.item() - ar.item()) <= 1e-3 * abs(ar.item())


def test_whisper_decode_after_prefill_full_size_on_card(cuda):
    """whisper-tiny at its published size in f32 on the card: 1,500 frames
    through the encoder, a 32-token decoder prefill (B5 once a decoder
    layer, never in the encoder), then 3 decode steps through the cached
    cross K/V, each step's logits within 1e-4 of a prefill over the whole
    sequence."""
    from repro_torch.model.layers import Ctx
    from repro_torch.model.lm import make_decode_step, make_prefill_step
    from repro_torch.model.transformer import apply_model, pad_cache
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg = get_config("whisper-tiny")
    par = ParallelismConfig(compute_dtype="float32", attn_impl="flash")
    params = Stepper(cfg, ShapeConfig("p", "prefill", 64, 1), SMOKE_MESH,
                     par).init(seed=6, device=cuda)
    rng = np.random.default_rng(6)
    frames = torch.as_tensor(rng.standard_normal(
        (1, cfg.encoder.n_positions, cfg.frontend_dim)), dtype=torch.float32,
        device=cuda)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, 35)),
                             device=cuda)
    with exact_f32_matmul(), torch.no_grad():
        before = flash_ops.launches
        _, cache = make_prefill_step(cfg, SMOKE_MESH, par)(
            params, {"tokens": tokens[:, :32], "frames": frames})
        assert flash_ops.launches - before == cfg.n_layers
        cache = pad_cache(cache, 40)
        assert all(c is None for c in cache["layers"][:4])
        assert all(c["ck"].shape == (1, 1500, 6, 64)
                   for c in cache["layers"][4:])
        decode = make_decode_step(cfg, SMOKE_MESH, par)
        for i in range(32, 35):
            got, cache = decode(params, tokens[:, i:i + 1], cache)
            full, _, _ = apply_model(
                params, {"tokens": tokens[:, :i + 1], "frames": frames},
                Ctx(cfg, SMOKE_MESH, "prefill", par=par, attn_impl="flash"))
            assert (got - full[:, -1]).abs().max().item() <= 1e-4


# --------------------------------------------------------------------------- #
# The hybrid and RWKV families on the card: B6 and B7 on every prefill
# --------------------------------------------------------------------------- #


def _family_smoke(arch):
    """The smoke config at the full configs' head widths: Zamba2's SSD
    heads of P = 64 with N = 64 (2 heads, 4 layers, the shared block after
    the 2nd and 4th), RWKV6's WKV heads of 64 (2 heads, 2 layers)."""
    from repro_torch.core.types import RWKVConfig, SSMConfig

    cfg = get_config(arch, smoke=True)
    if arch == "zamba2-7b":
        return cfg.with_(ssm=SSMConfig(d_state=64, expand=2, headdim=64,
                                       chunk=8))
    return cfg.with_(d_model=128, rwkv=RWKVConfig(head_size=64,
                                                  decay_lora=8, chunk=8))


def _family_setup(arch, cuda, impl="flash"):
    par = ParallelismConfig(compute_dtype="float32", attn_impl=impl)
    cfg = _family_smoke(arch)
    params = Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH,
                     par).init(seed=26, device=cuda)
    return cfg, par, params


def _chunked_seams(monkeypatch):
    """Point the blocks' scan seams at the chunked forms, as a CPU prefill
    runs them."""
    from repro_torch.model import rwkv as trwkv
    from repro_torch.model import ssm as tssm

    monkeypatch.setattr(tssm, "_ssd_scan", lambda x, dt, A, Bm, Cm, chunk,
                        h0, mode: ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                              h0=h0))
    monkeypatch.setattr(trwkv, "_wkv_scan", lambda r, k, v, w, u, h0, chunk,
                        mode: wkv6_chunked(r, k, v, w, u, h0=h0,
                                           chunk=chunk))


def _scaled_err(got, want) -> float:
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("arch,ops_mod,name", [
    ("zamba2-7b", ssd_ops, "ssd"), ("rwkv6-7b", wkv_ops, "wkv6")])
@pytest.mark.parametrize("S", [16, 13, 40])
def test_family_prefill_runs_its_kernel_once_a_layer(cuda, monkeypatch,
                                                     arch, ops_mod, name, S):
    """One prefill launches B6 (Zamba2) or B7 (RWKV6) once a layer and no
    other scan kernel; its logits and cache equal those of the same
    prefill through the chunked forms within 1e-4 (of the leaf's largest
    magnitude where above 1), at a ragged S too; a decode tick launches
    neither kernel."""
    from repro_torch.model.layers import tree_leaves
    from repro_torch.model.lm import make_decode_step, make_prefill_step
    from repro_torch.model.transformer import pad_cache
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg, par, params = _family_setup(arch, cuda)
    tokens = torch.as_tensor(np.random.default_rng(S).integers(
        2, cfg.vocab_size, (2, S)), device=cuda)
    prefill = make_prefill_step(cfg, SMOKE_MESH, par)
    with exact_f32_matmul(), torch.no_grad():
        before = (ssd_ops.launches, wkv_ops.launches)
        logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ran = (ssd_ops.launches - before[0], wkv_ops.launches - before[1])
        assert ran == ((cfg.n_layers, 0) if name == "ssd"
                       else (0, cfg.n_layers))
        assert ("shared" in cache) == (arch == "zamba2-7b")
        got = [t.clone() for t in tree_leaves(cache)]
        decode = make_decode_step(cfg, SMOKE_MESH, par)
        before = (ssd_ops.launches, wkv_ops.launches)
        _, _ = decode(params, tokens[:, -1:], pad_cache(cache, S + 2))
        torch.cuda.synchronize()
        assert (ssd_ops.launches, wkv_ops.launches) == before
        with monkeypatch.context() as m:
            _chunked_seams(m)
            want_logits, want_cache = prefill(params, {"tokens": tokens})
            assert (ssd_ops.launches, wkv_ops.launches) == before
    assert _scaled_err(logits, want_logits) <= 1e-4
    want = tree_leaves(want_cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.is_floating_point():
            assert _scaled_err(g.float(), w.float()) <= 1e-4
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b"])
def test_family_server_on_card_matches_the_chunked_path(cuda, monkeypatch,
                                                        arch):
    """The Server on the card with the kernels gives the greedy tokens of
    the same Server with the scans' chunked forms: 3 requests, 4 new
    tokens, 2 slots, f32."""
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg, par, params = _family_setup(arch, cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in (12, 13, 7)]

    def serve():
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=24,
                                               eos_token=-1), SMOKE_MESH,
                     par, device=cuda)
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
        return [r.out_tokens for r in srv.run_until_drained()]

    with exact_f32_matmul():
        ops_mod = ssd_ops if arch == "zamba2-7b" else wkv_ops
        before = ops_mod.launches
        got = serve()
        assert ops_mod.launches - before == 3 * cfg.n_layers
        with monkeypatch.context() as m:
            _chunked_seams(m)
            want = serve()
    assert got == want and all(len(t) == 4 for t in got)


def test_family_training_runs_the_chunked_forms_on_card(cuda):
    """B6 and B7 are forward-only: a train step on the card launches
    neither."""
    from repro_torch.model.layers import tree_leaves, value_and_grad
    from repro_torch.model.lm import make_loss_fn

    for arch in ("zamba2-7b", "rwkv6-7b"):
        cfg, par, params = _family_setup(arch, cuda)
        tok = torch.as_tensor(np.random.default_rng(1).integers(
            2, cfg.vocab_size, (2, 16)), device=cuda)
        before = (ssd_ops.launches, wkv_ops.launches)
        (loss, _), grads = value_and_grad(make_loss_fn(
            cfg, SMOKE_MESH, par), has_aux=True)(
            params, {"tokens": tok, "targets": tok})
        torch.cuda.synchronize()
        assert (ssd_ops.launches, wkv_ops.launches) == before
        assert torch.isfinite(loss)
        assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


# --------------------------------------------------------------------------- #
# The collectives on a world of one (the card sees one rank)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """An NCCL process group of one rank and the (1, 1) mesh on it; the
    group is destroyed after this module's card tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on it")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh((1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["psum", "a2a"])
def test_moe_ep_on_a_world_of_one_is_the_dense_oracle(cuda, world_of_one,
                                                      impl):
    """At a no-drop capacity (n_experts / top_k) ``moe_psum``/``moe_a2a``
    on the (1, 1) mesh give ``moe_dense``'s output within 1e-5 in f32,
    and the same gradients."""
    import dataclasses

    from repro_torch.core.types import MeshConfig
    from repro_torch.model import moe
    from repro_torch.model.layers import (Ctx, init_params, tree_leaves,
                                          tree_map)
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg = get_config("deepseek-moe-16b", smoke=True)
    m = cfg.moe
    cfg = cfg.with_(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = init_params(moe.moe_schema(cfg, tp=1), gen)
    x = torch.randn(2, 64, cfg.d_model, generator=gen, device=cuda)
    ctx = Ctx(cfg, MeshConfig((1, 1), ("data", "model")), "train",
              mesh=world_of_one,
              par=ParallelismConfig(compute_dtype="float32"))
    out = {}
    with exact_f32_matmul():
        for fn in (moe.moe_dense, moe.IMPLS[impl]):
            pp = tree_map(lambda t: t.detach().requires_grad_(True), p)
            xx = x.detach().requires_grad_(True)
            y, aux = fn(pp, xx, cfg, ctx)
            y.square().sum().backward()
            out[fn.__name__] = (y.detach(), aux.detach(), xx.grad,
                                [t.grad for t in tree_leaves(pp)
                                 if t.grad is not None])
    (y_d, a_d, g_d, p_d), (y_e, a_e, g_e, p_e) = out.values()
    assert (y_e - y_d).abs().max().item() <= 1e-5
    assert abs(a_e.item() - a_d.item()) <= 1e-6 * abs(a_d.item())
    assert (g_e - g_d).abs().max().item() <= 1e-5 * g_d.abs().max().item()
    for a, b in zip(p_e, p_d):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_quant_codes_on_card_equal_the_cpus(cuda):
    """``optim/compress.py::_quant``'s int8 codes and scale on the card
    equal the CPU's for the same f32 input (every division by a tensor:
    CUDA would turn a division by a Python float into a product)."""
    from repro_torch.optim.compress import _dequant, _quant

    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 1e4):
        x = (rng.standard_normal(1 << 16) * scale).astype(np.float32)
        s = np.float32(np.max(np.abs(x)) / np.float32(127.0))
        x[:64] = (np.arange(64, dtype=np.float32) - 31.5) * s
        q_c, s_c = _quant(torch.from_numpy(x))
        q_g, s_g = _quant(torch.from_numpy(x).to(cuda))
        assert torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c)
        assert torch.equal(_dequant(q_g, s_g).cpu(), _dequant(q_c, s_c))


def test_checkpoint_restores_onto_a_card_mesh_bit_for_bit(cuda, world_of_one,
                                                          tmp_path):
    """A state saved from the CPU restores through
    ``load_checkpoint(shardings=)`` onto the (1, 1) card mesh bit for bit
    (each leaf its rank's block: the whole leaf), bf16 leaves included."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.types import MeshConfig
    from repro_torch.model.layers import tree_leaves, tree_map
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import init_opt_state

    cfg = get_config("deepseek-moe-16b", smoke=True)
    st = Stepper(cfg, ShapeConfig("t", "train", 16, 2),
                 MeshConfig((1, 1), ("data", "model")),
                 ParallelismConfig(compute_dtype="float32"),
                 mesh=world_of_one)
    params = st.init(seed=3, device="cpu", dtype_override=torch.bfloat16)
    state = {"params": params, "opt": init_opt_state(params)}
    state["opt"]["mu"] = tree_map(lambda t: t + 0.5, state["opt"]["mu"])
    save_checkpoint(str(tmp_path), 4, state)
    like = tree_map(lambda t: torch.empty_like(t, device=cuda), state)
    back = load_checkpoint(str(tmp_path), 4, like,
                           shardings=st.state_shardings())
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


def test_mesh_trainer_on_a_world_of_one_is_the_meshless_trainer(
        cuda, world_of_one, tmp_path):
    """The mesh train step on the (1, 1) card mesh, under
    ``grad_compression`` (not read on one rank): 3 ``Trainer`` steps with
    a checkpoint after each give the meshless trainer's losses bit for
    bit; the checkpoint, gathered to the writer and restored with the
    mesh's shardings, equals the trained state bit for bit."""
    from repro_torch.data.pipeline import LMDataConfig
    from repro_torch.model.layers import tree_leaves
    from repro_torch.model.lm import Stepper
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_config("yi-9b", smoke=True)
    shape = ShapeConfig("t", "train", 16, 4)
    par = ParallelismConfig(compute_dtype="float32", grad_compression=True)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4)
    losses, trainers = [], []
    for k, mesh in enumerate((None, world_of_one)):
        st = Stepper(cfg, shape, SMOKE_MESH, par, mesh=mesh)
        tr = Trainer(st, dcfg, TrainerConfig(
            total_steps=3, ckpt_every=1, ckpt_dir=str(tmp_path / str(k)),
            log_every=1), device="cuda")
        out = tr.train()
        losses.append([r["loss"] for r in out["metrics"]])
        trainers.append((tr, st, out["state"]))
    assert losses[1] == losses[0]
    tr, st, trained = trainers[1]
    assert tr.is_writer
    step, back = tr.resume_elastic(st, shardings=st.state_shardings())
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(trained)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_card_tp_split_step_on_a_world_of_one_is_the_meshless_step(
        cuda, world_of_one, monkeypatch):
    """The ``"model"``-split train step's gradient (``lm._mesh_grad_fn``,
    every attention, MLP, embedding and head computed as the rank's share,
    here the whole on a model axis of 1) on the (1, 1) card mesh in bf16
    with B5: the loss and every gradient leaf equal the meshless step's
    bit for bit, and B5 ``sm90`` runs on the rank's heads (all of them),
    twice a layer (the forward and its recompute), as in the meshless
    step."""
    from repro_torch.core.types import MeshConfig
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model import lm
    from repro_torch.model.layers import (local_blocks, tree_leaves,
                                          value_and_grad)

    cfg = get_config("yi-9b", smoke=True)
    mcfg = MeshConfig((1, 1), ("data", "model"))
    par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    st = Stepper(cfg, ShapeConfig("t", "train", 64, 2), mcfg, par,
                 mesh=world_of_one)
    params = st.init(seed=4, device=cuda)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             lm_batch_for_step(LMDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=64, global_batch=2),
                               0).items()}
    heads = []
    real = flash_ops.flash_attention_cuda

    def counted(q, *a, **kw):
        heads.append(q.shape[2])
        return real(q, *a, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_cuda", counted)
    runs = []
    for split in (None, True):
        flash_ops.launches_by_variant = dict.fromkeys(
            flash_ops.launches_by_variant, 0)
        heads.clear()
        if split is None:
            (loss, _), grads = value_and_grad(lm.make_loss_fn(
                cfg, SMOKE_MESH, par), has_aux=True)(params, batch)
        else:
            blocks = local_blocks(params, st.state_shardings()["params"])
            loss, _, grads = lm._mesh_grad_fn(cfg, mcfg, par, world_of_one)(
                blocks, batch)
        torch.cuda.synchronize()
        runs.append((loss, tree_leaves(grads),
                     dict(flash_ops.launches_by_variant), list(heads)))
    (l0, g0, v0, h0), (l1, g1, v1, h1) = runs
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    assert v1 == v0 == {"sm90": 2 * cfg.n_layers, "simt": 0}
    assert h1 == h0 == [cfg.n_heads] * (2 * cfg.n_layers)


def test_card_tp_zamba2_on_a_world_of_one_is_the_meshless_model(
        cuda, world_of_one, monkeypatch):
    """The zamba2 smoke in f32 on the (1, 1) card mesh, its Mamba-2 mixers
    and shared block computed as the rank's share (here the whole on a
    model axis of 1): ``Server(mesh=)``'s greedy tokens equal the meshless
    ``Server``'s, B6 runs on the rank's heads once a layer of each
    prefill and B5 on the shared block's q heads, and the split train
    step's loss and every gradient leaf equal the meshless step's bit for
    bit."""
    from repro_torch.core.types import MeshConfig
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model import lm
    from repro_torch.model.layers import (local_blocks, tree_leaves,
                                          value_and_grad)
    from repro_torch.model.ssm import mamba_dims
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = get_config("zamba2-7b", smoke=True)
    mcfg = MeshConfig((1, 1), ("data", "model"))
    par = ParallelismConfig(compute_dtype="float32", attn_impl="flash")
    st = Stepper(cfg, ShapeConfig("t", "train", 32, 2), mcfg, par,
                 mesh=world_of_one)
    params = st.init(seed=5, device=cuda)
    heads = []
    real = ssd_ops.ssd_cuda

    def counted(x, *a, **kw):
        heads.append(x.shape[2])
        return real(x, *a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_cuda", counted)
    prompts = ([5, 9, 13, 17, 21, 25, 27], [7, 11, 3, 19, 23, 29, 31])
    served = []
    for mesh_cfg, mesh in ((SMOKE_MESH, None), (mcfg, world_of_one)):
        ssd_ops.launches = 0
        flash_ops.launches_by_variant = dict.fromkeys(
            flash_ops.launches_by_variant, 0)
        heads.clear()
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=12,
                                               eos_token=-1),
                     mesh_cfg, par, device=cuda, mesh=mesh)
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
        served.append(([list(r.out_tokens) for r in srv.run_until_drained()],
                       ssd_ops.launches, list(heads),
                       sum(flash_ops.launches_by_variant.values())))
    (t0, n0, h0, f0), (t1, n1, h1, f1) = served
    _, n_heads, _, _ = mamba_dims(cfg)
    assert t1 == t0
    assert n1 == n0 == len(prompts) * cfg.n_layers
    assert h1 == h0 == [n_heads] * n0
    assert f1 == f0 == len(prompts) * len(cfg.shared_attn_points())
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             lm_batch_for_step(LMDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=32, global_batch=2),
                               0).items()}
    (l0, _), g0 = value_and_grad(lm.make_loss_fn(cfg, SMOKE_MESH, par),
                                 has_aux=True)(params, batch)
    blocks = local_blocks(params, st.state_shardings()["params"])
    l1, _, g1 = lm._mesh_grad_fn(cfg, mcfg, par, world_of_one)(blocks, batch)
    torch.cuda.synchronize()
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                 tree_leaves(g0)))


def test_card_tp_rwkv6_on_a_world_of_one_is_the_meshless_model(
        cuda, world_of_one, monkeypatch):
    """The rwkv6 smoke in f32 on the (1, 1) card mesh, its time-mix and
    channel-mix computed as the rank's share (here the whole on a model
    axis of 1): ``Server(mesh=)``'s greedy tokens equal the meshless
    ``Server``'s, B7 runs on the rank's heads once a layer of each
    prefill, the served ``wkv`` state holds them, and the split train
    step's loss and every gradient leaf equal the meshless step's bit for
    bit (B7 does not run in training)."""
    from repro_torch.core.types import MeshConfig
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model import lm
    from repro_torch.model.layers import (local_blocks, tree_leaves,
                                          value_and_grad)
    from repro_torch.model.rwkv import rwkv_dims

    cfg = get_config("rwkv6-7b", smoke=True)
    mcfg = MeshConfig((1, 1), ("data", "model"))
    par = ParallelismConfig(compute_dtype="float32")
    st = Stepper(cfg, ShapeConfig("t", "train", 32, 2), mcfg, par,
                 mesh=world_of_one)
    params = st.init(seed=5, device=cuda)
    heads = []
    real = wkv_ops.wkv6_cuda

    def counted(r, *a, **kw):
        heads.append(r.shape[2])
        return real(r, *a, **kw)

    monkeypatch.setattr(wkv_ops, "wkv6_cuda", counted)
    prompts = ([5, 9, 13, 17, 21, 25, 27], [7, 11, 3, 19, 23, 29, 31])
    served = []
    for mesh_cfg, mesh in ((SMOKE_MESH, None), (mcfg, world_of_one)):
        wkv_ops.launches = 0
        heads.clear()
        srv = Server(cfg, params, ServerConfig(batch_slots=2, max_len=12,
                                               eos_token=-1),
                     mesh_cfg, par, device=cuda, mesh=mesh)
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
        served.append(([list(r.out_tokens) for r in srv.run_until_drained()],
                       wkv_ops.launches, list(heads),
                       int(srv._cache["layers"][0]["wkv"].shape[1])))
    (t0, n0, h0, c0), (t1, n1, h1, c1) = served
    n_heads, _ = rwkv_dims(cfg)
    assert t1 == t0
    assert n1 == n0 == len(prompts) * cfg.n_layers
    assert h1 == h0 == [n_heads] * n0
    assert c1 == c0 == n_heads
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             lm_batch_for_step(LMDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=32, global_batch=2),
                               0).items()}
    wkv_ops.launches = 0
    (l0, _), g0 = value_and_grad(lm.make_loss_fn(cfg, SMOKE_MESH, par),
                                 has_aux=True)(params, batch)
    blocks = local_blocks(params, st.state_shardings()["params"])
    l1, _, g1 = lm._mesh_grad_fn(cfg, mcfg, par, world_of_one)(blocks, batch)
    torch.cuda.synchronize()
    assert wkv_ops.launches == 0
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                 tree_leaves(g0)))
