"""Plain PyTorch version of B5 (port of
``repro/kernels/flash_attention/ref.py::attention_ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: bar of :func:`rel_rms_by_block` for a bf16 kernel output against the f32
#: plain version on the same bf16 inputs. A sound output reads under 0.003
#: there (the output's and the weights' rounding to bf16); a key tile lost
#: or read from a stale buffer reads 0.2 or more.
BF16_REL_RMS_BAR = 2 ** -7


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


def rel_rms_by_block(got: torch.Tensor, want: torch.Tensor,
                     rows: int = 128) -> float:
    """The largest rms(got - want) / rms(want) over the blocks of ``rows``
    query rows of each (batch, head) of two (B, S, H, hd) outputs.

    An absolute bar does not see a fault in rows whose values are small (a
    long, nearly uniform softmax averages v down to about std / sqrt(S));
    this one scales with each block's own output.
    """
    d = (got.float() - want.float()).transpose(1, 2)
    w = want.float().transpose(1, 2)
    pad = (0, 0, 0, -d.shape[2] % rows)
    B, H, _, hd = d.shape
    num = F.pad(d, pad).reshape(B, H, -1, rows * hd).square().sum(-1)
    den = F.pad(w, pad).reshape(B, H, -1, rows * hd).square().sum(-1)
    return (num / den.clamp_min(1e-30)).sqrt().max().item()
