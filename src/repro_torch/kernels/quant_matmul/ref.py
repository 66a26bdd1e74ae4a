"""Plain PyTorch version of B4 (port of
``repro/kernels/quant_matmul/ref.py``): the exact int8 product and the
per-tensor activation quantizer."""
from __future__ import annotations

import torch


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 codes · (K, N) int8 codes -> exact int32 sums.

    ``torch.matmul`` has no int8/int32 path on CUDA, so the codes are
    multiplied as float64: every product is below 2^14 and every sum over
    K below 2^14 · K, far inside float64's 53-bit mantissa, so the sums are
    exact in any order, on the CPU as on the card.
    """
    return torch.matmul(xq.double(), wq.double()).to(torch.int32)


def quant_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(f32(xq · wq) · x_scale) · w_scale[col], in that order."""
    acc = int8_dot(xq, wq)
    return (acc.float() * x_scale.reshape(())
            * w_scale.reshape(1, -1)).to(out_dtype)


def quantize_act(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization of activations: (codes,
    scale), with ``round`` half to even as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.float()
