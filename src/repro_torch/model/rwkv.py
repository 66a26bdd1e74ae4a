"""RWKV-6 WKV recurrence oracles (port of ``wkv6_step`` and
``wkv6_reference`` of ``repro/model/rwkv.py``).

The per-step recurrence the WKV6 kernel (``kernels/rwkv6``) is held
against: y = r·(S + diag(u) k vᵀ), S ← diag(e^{w}) S + k vᵀ, with S the
(N, N) key → value state of each head. The chunked form and the RWKV-6
block come with the RWKV family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_step(r, k, v, w_log, u, h):
    """Single decode step. r/k/v/w_log: (B,H,N); h: (B,H,N,N) key->value."""
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus = torch.einsum("bhn,hn,bhn->bh", rf, u.float(), kf)
    y = torch.einsum("bhn,bhnp->bhp", rf, h) + bonus[..., None] * vf
    h_new = h * torch.exp(w_log.float())[..., None] \
        + torch.einsum("bhn,bhp->bhnp", kf, vf)
    return y.to(r.dtype), h_new


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive scan oracle. r/k/v/w_log: (B,S,H,N); u: (H,N). Returns
    (y (B,S,H,N) in r's dtype, final state (B,H,N,N) f32)."""
    B, S, H, N = r.shape
    h = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        y, h = wkv6_step(r[:, t], k[:, t], v[:, t], w_log[:, t], u, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h
