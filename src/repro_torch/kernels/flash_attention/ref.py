"""Plain PyTorch version of B5 (port of
``repro/kernels/flash_attention/ref.py::attention_ref``)."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, S, H, hd) — plain softmax attention, f32 math; the
    weights are rounded to v's dtype before the PV product, and the output
    is in v's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        logits = logits.masked_fill(~mask[None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
