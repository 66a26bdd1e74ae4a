"""Mamba-2 SSD recurrence oracles (port of ``ssd_step`` and
``ssd_reference`` of ``repro/model/ssm.py``).

The per-step recurrence the SSD chunk-scan kernel (``kernels/mamba2``) is
held against: h ← e^{dt·A} h + (dt·x) ⊗ B, y = h · C. The chunked einsum
form and the Mamba-2 block come with the Zamba2 family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_step(
    x: torch.Tensor,        # (B, H, P)
    dt: torch.Tensor,       # (B, H) f32 post-softplus
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B, G, N)
    Cm: torch.Tensor,       # (B, G, N)
    h: torch.Tensor,        # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the recurrence. Returns (y (B,H,P), h')."""
    G = Bm.shape[1]
    rep = x.shape[1] // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()   # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
    da = torch.exp(dt * A[None, :])                         # (B,H)
    xf = x.float()
    h_new = h * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xf * dt[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive per-step recurrence. x:(B,S,H,P) dt:(B,S,H) B/C:(B,S,G,N).
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        y, h = ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h
