"""Fixed-point (Q-format) quantization — the paper's core optimization.

Port of ``repro/quant/fixedpoint.py``: Q(total_bits, frac_bits) with
round-half-even and saturation, the integer-domain requant that the
emulator and both CUDA kernels share, and the straight-through fake-quant
that makes the same graph trainable (QAT). ``torch.round`` rounds half to
even, like ``jnp.round``, so codes agree integer for integer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FxpFormat:
    """Q(total_bits, frac_bits): 1 sign bit, total-frac-1 integer bits."""

    total_bits: int = 8
    frac_bits: int = 6

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def lo(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def hi(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    @property
    def max_value(self) -> float:
        return self.hi / self.scale

    def __str__(self) -> str:
        return f"Q{self.total_bits}.{self.frac_bits}"


def fxp_quantize(x, fmt: FxpFormat) -> torch.Tensor:
    """Round-to-nearest-even, saturating. Returns the *dequantized* f32."""
    q = torch.round(torch.as_tensor(x).to(torch.float32) * fmt.scale)
    q = torch.clamp(q, fmt.lo, fmt.hi)
    return q / fmt.scale


def fxp_to_int(x, fmt: FxpFormat) -> torch.Tensor:
    """The integer codes an RTL template would hold in BRAM (int8, int16
    or int32, the narrowest that holds the format)."""
    q = torch.round(torch.as_tensor(x).to(torch.float32) * fmt.scale)
    q = torch.clamp(q, fmt.lo, fmt.hi)
    dtype = torch.int8 if fmt.total_bits <= 8 else torch.int16 \
        if fmt.total_bits <= 16 else torch.int32
    return q.to(dtype)


def fxp_requant_int(v: torch.Tensor, from_frac: int,
                    fmt: FxpFormat) -> torch.Tensor:
    """Integer-domain rescale: the exact counterpart of ``fxp_quantize``.

    ``v`` holds codes at scale ``2**from_frac``; the result holds the codes
    of ``fxp_quantize(v / 2**from_frac, fmt)`` — a round-half-even
    arithmetic right shift (or an exact left shift) and a saturate, in
    int32 throughout.
    """
    v = v.to(torch.int32)
    s = from_frac - fmt.frac_bits
    if s > 0:                       # narrow: round-half-even right shift
        q0 = v >> s
        rem = v - (q0 << s)
        half = 1 << (s - 1)
        inc = (rem > half) | ((rem == half) & ((q0 & 1) == 1))
        q = q0 + inc.to(torch.int32)
    elif s < 0:                     # widen: exact left shift
        q = v << -s
    else:
        q = v
    return torch.clamp(q, fmt.lo, fmt.hi)


class _FxpFakeQuant(torch.autograd.Function):
    """Round-half-even and saturate in the forward; in the backward a
    straight-through gradient, masked to zero where ``x * scale`` lies
    outside ``[lo, hi]`` (inclusive at both ends, taken before rounding),
    as the reference's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, x, scale: float, lo: float, hi: float):
        xs = x * scale
        ctx.save_for_backward((xs >= lo) & (xs <= hi))
        return torch.clamp(torch.round(xs), lo, hi) / scale

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return torch.where(inside, g, 0.0), None, None, None


def fxp_fake_quant(x: torch.Tensor, scale: float, lo: float,
                   hi: float) -> torch.Tensor:
    """Dequantized ``clip(round(x * scale), lo, hi) / scale`` with the
    saturation-masked straight-through gradient."""
    return _FxpFakeQuant.apply(x, scale, lo, hi)


def fake_quant(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return fxp_fake_quant(x.to(torch.float32), fmt.scale, float(fmt.lo),
                          float(fmt.hi))


def pick_frac_bits(x, total_bits: int) -> int:
    """Largest frac_bits such that amax still fits (power-of-two scale)."""
    amax = float(torch.as_tensor(x).abs().max())
    if amax == 0.0:
        return total_bits - 1
    int_bits = max(0, math.ceil(math.log2(amax + 1e-12) + 1e-9) + 1)
    return max(0, min(total_bits - 1, total_bits - 1 - int_bits))


def quant_error(x, fmt: FxpFormat) -> float:
    """RMS quantization error — reported in the creator's stage-1 report."""
    x = torch.as_tensor(x).to(torch.float32)
    return float(torch.sqrt(torch.mean(torch.square(x - fxp_quantize(x,
                                                                   fmt)))))
