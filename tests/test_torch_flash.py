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
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(*meta)
