"""Plain PyTorch version of the decode-attention kernel
(``csrc/decode_attention.cu``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd) against the unrepeated cache k, v (B, S, KV, hd),
    q head h reading kv head h // (H // KV), row b's keys j < kv_len[b]
    (all S where kv_len[b] > S): f32 scores and softmax, the weights
    rounded to v's dtype before the PV product. Returns (B, 1, H, hd) in
    v's dtype. The grouped form of ``model/attention.py``'s plain
    attention under the ``kv_len`` mask."""
    B, sq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, sq, KV, H // KV, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * hd ** -0.5
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.reshape(-1, 1))
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return o.reshape(B, sq, H, hd)
