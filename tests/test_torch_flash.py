"""PyTorch port, kernel B5 (flash attention): the wrapper's plain version on
the CPU against the JAX template (Pallas in interpret mode) and its oracle
``attention_ref``, at the reference's test shapes. The CUDA kernel is held
against the plain version on the card in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (BF16_REL_RMS_BAR,
                                                     rel_rms_by_block)

# tests/test_kernels.py::test_flash_attention_fwd's shapes (B, S, H, hd)
SHAPES = [(2, 256, 4, 64), (1, 512, 2, 128), (2, 256, 3, 96),
          (1, 384, 2, 160)]
F32_TOL = 2e-5       # the reference's bar for the f32 template
BF16_TOL = 0.03      # ... and for bf16 in, against the f32 oracle


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * 0.5).astype(dtype)
                 for _ in range(3))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_template_and_oracle(shape, causal):
    q, k, v = _qkv(shape, sum(shape))
    before = flash_ops.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    assert flash_ops.launches == before          # CPU: no kernel launch
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (j_flash(jq, jk, jv, causal), j_attention_ref(jq, jk, jv,
                                                             causal)):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err < F32_TOL, err


def test_bf16_within_tolerance_of_f32_oracle():
    q, k, v = _qkv((2, 256, 2, 64), 2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_attention_ref(*(jnp.asarray(t.float().numpy())
                                        for t in (tq, tk, tv)), True))
    assert np.abs(got.float().numpy() - want).max() < BF16_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_17_tokens(causal):
    """S = 17 has no power-of-two block >= 8: the reference wrapper falls
    back to its oracle there; the port's wrapper takes every S."""
    q, k, v = _qkv((1, 17, 2, 64), 17)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    want = j_flash(*map(jnp.asarray, (q, k, v)), causal)
    assert np.abs(got.numpy() - np.asarray(want)).max() < F32_TOL


def test_plain_version_rounds_weights_to_v_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 9, 1, 16), 3))
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                      * 0.25 + torch.triu(torch.full((9, 9), -1e30), 1),
                      dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", w.to(torch.bfloat16), v)
    assert torch.equal(attention_ref(q, k, v, True), want)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_checks_and_refuses_other_devices():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 2, 16), 4))
    with pytest.raises(ValueError, match="GQA-repeated"):
        flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="share one of"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)
    with pytest.raises(ValueError, match="hd <= 256"):
        big = torch.zeros(1, 2, 1, 272)
        flash_attention(big, big, big)
    # a meta tensor computes nothing: the empty result comes back, with the
    # kernel's shape, dtype and layout
    out = flash_attention(*(t.to("meta") for t in (q, k, v)))
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    assert out.is_contiguous()
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        flash_attention(*(t.as_subclass(_Elsewhere) for t in (q, k, v)))


# ---- routing between the kernel's two variants ------------------------------
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 100, 112, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_by_dtype_and_head_dim(dtype, hd):
    """sm90 takes bf16 with hd <= 128 a multiple of 8; simt the rest."""
    q = torch.zeros((1, 4, 2, hd), dtype=dtype)
    want = ("sm90" if dtype == torch.bfloat16 and hd <= 128 and hd % 8 == 0
            else "simt")
    assert flash_ops.variant(q, q, q) == want


def test_variant_needs_16_byte_strides_and_bases():
    ok = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    assert flash_ops.variant(ok, ok, ok) == "sm90"
    narrow = torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16)[..., :64]
    assert narrow.stride() == (2176, 136, 68, 1)      # 136 B: not 16-byte
    for args in ((narrow, ok, ok), (ok, narrow, ok), (ok, ok, narrow)):
        assert flash_ops.variant(*args) == "simt"
    flat = torch.zeros(16 * 2 * 64 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    shifted = flat[1:1 + 16 * 2 * 64].view(1, 16, 2, 64)   # base 2 B off
    assert flash_ops.variant(ok, shifted, ok) == "simt"
    aligned = flat[8:8 + 16 * 2 * 64].view(1, 16, 2, 64)   # base 16 B off
    assert flash_ops.variant(ok, aligned, ok) == "sm90"


def test_variant_takes_the_transposed_view():
    """(B, H, S, hd) buffers seen as (B, S, H, hd): TMA reads the strides
    as they are, so bf16 needs no copy."""
    q = torch.zeros((2, 3, 70, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous()
    assert flash_ops.variant(q, q, q) == "sm90"
    assert flash_ops.variant(q.float(), q.float(), q.float()) == "simt"


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 33, 2, 64), 5))
    assert flash_ops.variant(q, k, v) == "sm90"
    before = (flash_ops.launches, dict(flash_ops.launches_by_variant))
    got = flash_attention(q, k, v, True)
    assert torch.equal(got, attention_ref(q, k, v, True))
    assert (flash_ops.launches, flash_ops.launches_by_variant) == before


# ---- the block-relative bar the card tests hold bf16 kernels to -------------
def _bf16_qkv(shape, seed):
    return tuple(torch.from_numpy(a).to(torch.bfloat16)
                 for a in _qkv(shape, seed))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_template_and_plain_version_within_block_bar(causal):
    """The reference's bf16 template (Pallas, interpret mode) and the
    port's bf16 plain version both read within the bar against the f32
    oracle: the bar leaves room for sound bf16 rounding."""
    q, k, v = _bf16_qkv((1, 512, 2, 128), 6)
    want = attention_ref(q.float(), k.float(), v.float(), causal)
    ref = torch.from_numpy(np.asarray(
        j_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v)), causal), np.float32))
    for got in (attention_ref(q, k, v, causal), ref):
        err = rel_rms_by_block(got, want)
        assert 0 < err < BF16_REL_RMS_BAR, err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fault", ["stale_stage", "lost_last_tile"])
def test_block_bar_fails_a_stale_or_lost_key_tile(fault, causal):
    """Planted faults of a 2-stage ring of 128-key tiles at a Yi-9B prefill
    length: keys 256-383 read from the stage keys 0-127 left behind, or
    the ragged last tile of S = 2047 dropped. Both move small outputs
    (std 0.5 inputs give |out| near 0.5 / sqrt(row + 1)), so the block
    bar, not an absolute one, has to catch them."""
    S = 2048 if fault == "stale_stage" else 2047
    q, k, v = _bf16_qkv((1, S, 2, 128), S)
    want = attention_ref(q.float(), k.float(), v.float(), causal)
    if fault == "stale_stage":
        k, v = k.clone(), v.clone()
        k[:, 256:384], v[:, 256:384] = k[:, :128], v[:, :128]
    else:
        k, v = k[:, :S // 128 * 128], v[:, :S // 128 * 128]
    assert rel_rms_by_block(attention_ref(q, k, v, causal),
                            want) > 10 * BF16_REL_RMS_BAR
