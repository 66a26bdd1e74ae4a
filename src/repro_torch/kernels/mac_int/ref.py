"""Plain PyTorch version of the integer MAC template (port of
``repro/rtl/oplib.py::_mac_int_jnp``).

``torch.matmul`` has no int32 CUDA implementation, so the product is taken
exactly in int64, one input column at a time, and cast back to int32, which
wraps like a C cast — the two's-complement result of
``dot_general(..., preferred_element_type=int32)``. Runs on the CPU and on
CUDA alike; the kernel is compared with it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.quant.fixedpoint import FxpFormat, fxp_requant_int

_ACC = FxpFormat(32, 0)


def matmul_int32(xh: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(B, K) int @ (K, N) int + (N,) int, wrapped to int32."""
    acc = b.to(torch.int64).expand(xh.shape[0], -1).clone()
    for k in range(xh.shape[1]):
        acc += xh[:, k:k + 1].to(torch.int64) * w[k].to(torch.int64)
    return acc.to(torch.int32)


def mac_int_ref(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                shift: int, lo: int, hi: int) -> torch.Tensor:
    """clip(requant(xh @ w + b, shift), lo, hi) -> (B, N) int32."""
    acc = matmul_int32(xh, w, b)
    return torch.clamp(fxp_requant_int(acc, shift, _ACC), lo, hi)
