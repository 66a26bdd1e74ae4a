"""Public wrapper of the flash-attention template (B5): the reference's
``(B, S, H, hd)`` layout with GQA-repeated K/V.

Training goes through a ``torch.autograd.Function``, as the reference's
``jax.custom_vjp``: kernel forward, and a backward that is the VJP of the
plain version recomputed from ``(q, k, v)`` (no backward kernel, as in the
reference). The Function is the only path to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.flash_attention.kernel import (DTYPES,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches made by :func:`flash_attention` (CPU calls do not count)
launches = 0
#: ... and by the variant :func:`variant` chose
launches_by_variant = {"sm90": 0, "simt": 0}

MAX_HEAD_DIM = 256
SM90_MAX_HEAD_DIM = 128


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call with these (checked) operands launches,
    decided from dtype, head dim, strides and alignment alone.

    ``"sm90"`` (tensor cores, TMA-fed): bf16, hd <= 128 and a multiple of 8,
    and for each of q, k, v a 16-byte-aligned base and (b, s, h) strides
    that are positive multiples of 16 bytes, as TMA requires. ``"simt"``
    (CUDA cores) takes everything else: f32, hd > 128, other strides.
    """
    hd = q.shape[-1]
    if (q.dtype != torch.bfloat16 or hd > SM90_MAX_HEAD_DIM or hd % 8):
        return "simt"
    for t in (q, k, v):
        size = t.element_size()
        if t.data_ptr() % 16 or any(s <= 0 or s * size % 16
                                    for s in t.stride()[:3]):
            return "simt"
    return "sm90"


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, hd),"
                             f" got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k, v "
                             f"must share one of {sorted(map(str, DTYPES))}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                         "(K/V must be GQA-repeated)")
    if Sq < 1 or k.shape[1] < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs S >= 1 and 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal attention of ``sq`` queries over ``sk``
    keys scores: key j <= query i, as the plain version masks."""
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def attention_flops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> int:
    """The two products of the function: 4 · hd per scored (query, key)
    pair of each (batch, head)."""
    B, sq, H, hd = q.shape
    sk = k.shape[1]
    pairs = causal_pairs(sq, sk) if causal else sq * sk
    return 4 * B * H * hd * pairs


class _Flash(torch.autograd.Function):
    """B5 with the reference's gradient (``repro/kernels/flash_attention/
    ops.py::_bwd``): the forward launches the kernel (the plain version on
    a CPU tensor) and saves ``(q, k, v)``; the backward recomputes the
    plain version from them and returns its VJP of ``dout``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = attention_ref(*qkv, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None


@reports("flash_attention", attention_flops)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, S, H, hd) (K/V already GQA-repeated). Returns
    (B, Sq, H, hd) in q's dtype, differentiable in q, k and v.

    On a CUDA tensor this launches the kernel :func:`variant` names, for
    every S and every hd <= 256 (the kernels mask ragged tiles themselves),
    and raises if it fails; on a CPU tensor it runs the plain version; on
    a ``meta`` tensor it returns the empty result. Every forward counts,
    a rematerialised one included; the backward launches no kernel.
    """
    _check(q, k, v)
    return _Flash.apply(q, k, v, causal)


def _forward(q, k, v, causal):
    global launches
    if q.device.type == "cpu":
        # in the kernel's layout, so the caller's reshape is a view on
        # every device
        return attention_ref(q, k, v, causal).contiguous()
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    name = variant(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        flash_attention_cuda(q, k, v, out, causal=causal, variant=name)
    launches += 1
    launches_by_variant[name] += 1
    return out
