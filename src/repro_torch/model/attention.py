"""Grouped-query attention with KV cache, qk-norm, RoPE and the q-chunked
long-sequence path (port of ``repro/model/attention.py``).

The plain path is PyTorch einsum; ``ctx.attn_impl == "flash"`` sends every
causal attention with Sq == Sk (each prefill and training layer) to B5
(``kernels/flash_attention``) and every decode self-attention to the
decode kernel (``kernels/decode_attention``), which reads the unrepeated
cache up to each row's length. Decode writes the new K/V into the cache in
place (``index_put_``) where the reference updates a donated buffer.

Where the step computes split (``Ctx.split``) and the q heads divide the
``"model"`` axis, each rank computes its ``n_heads / tp`` q heads, its
``n_kv_heads / tp`` kv heads where those divide too (its cache holds
them) and every kv head where they do not, and sums ``wo``'s partial
products over the axis; a config whose q heads do not divide the axis
computes the whole attention on every rank, as the reference's layout
keeps it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import (Ctx, PSpec, apply_rope, checkpoint,
                                      model_sum, pspec, rms_head_norm,
                                      rope_angles, shard_axis)

# Sequences longer than this use the q-chunked (flash-style, O(S) memory) path.
FULL_ATTN_MAX_SEQ = 1024
Q_CHUNK = 512
NEG_INF = -1e30


def attn_schema(cfg: ModelConfig, tp: int = 16, cross: bool = False,
                d_in: int = 0, d_out: int = 0, n_heads: int = 0,
                n_kv_heads: int = 0):
    """One attention layer's leaves; ``d_in``/``d_out``/``n_heads``/
    ``n_kv_heads`` default to the config's (``cross`` changes nothing: a
    cross-attention has the same leaves, its K/V projections applied to
    the encoder's output). Heads shard over ``"model"`` where their count
    divides ``tp``; K/V stay replicated where theirs does not."""
    d = d_in or cfg.d_model
    h = n_heads or cfg.n_heads
    kv = n_kv_heads or cfg.n_kv_heads
    hd = cfg.hd
    ha, kva = shard_axis(h, tp), shard_axis(kv, tp)
    sch = {
        "wq": PSpec((d, h * hd), (None, ha)),
        "wk": PSpec((d, kv * hd), (None, kva)),
        "wv": PSpec((d, kv * hd), (None, kva)),
        "wo": PSpec((h * hd, d_out or d), (ha, None)),
    }
    if cfg.qk_norm:
        sch["q_norm"] = PSpec((hd,), init="ones")
        sch["k_norm"] = PSpec((hd,), init="ones")
    return sch


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


def _rank_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, H: int):
    """The kv heads (of all ``n_kv_heads``) this rank's ``H`` q heads read
    where the q heads are split over ``"model"`` and the kv heads are not:
    whole q head ``h`` reads kv head ``h // (n_heads // n_kv_heads)``. A
    run of whole groups is sliced (the caller repeats it as usual); a
    share that cuts a group gets one kv head a q head."""
    from repro_torch import shardmap

    g = cfg.n_heads // cfg.n_kv_heads
    lo = shardmap.axis_index("model") * H
    idx = [(lo + i) // g for i in range(H)]
    n = idx[-1] - idx[0] + 1
    if H % n == 0 and idx == [idx[0] + i // (H // n) for i in range(H)]:
        return k[:, :, idx[0]:idx[0] + n], v[:, :, idx[0]:idx[0] + n]
    return k[:, :, idx], v[:, :, idx]


def attention_core(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, H or KV, hd)
    v: torch.Tensor,            # (B, Sk, H or KV, hd)
    ctx: Ctx,
    causal: bool,
    q_offset: int = 0,          # absolute position of q[:, 0]
    kv_len: Optional[torch.Tensor] = None,  # valid cache length (decode)
) -> torch.Tensor:
    """Softmax attention; dispatches kernel B5 / full block / q-chunked."""
    if ctx.attn_impl == "flash" and causal and q.shape[1] == k.shape[1]:
        from repro_torch.kernels.flash_attention import ops as flash_ops

        return flash_ops.flash_attention(q, k, v, causal=True)
    # un-repeated K/V (fewer kv heads) -> grouped GQA path
    block = _attn_block_grouped if k.shape[2] != q.shape[2] else _attn_block
    scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    if sq <= FULL_ATTN_MAX_SEQ or sq != sk:
        return block(q, k, v, scale, causal, q_offset, kv_len)
    # q-chunked path: O(S) live memory, exact softmax per row; the last
    # chunk is ragged where the reference pads it (same rows either way).
    # Training recomputes each chunk's logits in the backward.
    body = checkpoint(block) if ctx.mode == "train" else block
    return torch.cat([body(q[:, i:i + Q_CHUNK], k, v, scale, causal, i,
                           kv_len) for i in range(0, sq, Q_CHUNK)], dim=1)


def _mask(sq: int, sk: int, causal: bool, q_offset: int,
          kv_len: Optional[torch.Tensor], device, lead: int):
    """Boolean mask broadcastable to the logits ((B or 1), 1.., Sq, Sk),
    with ``lead`` singleton axes between batch and (Sq, Sk); None if
    nothing is masked."""
    mask = None
    if causal:
        qpos = q_offset + torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        mask = (kpos <= qpos).reshape((1,) * (lead + 1) + (sq, sk))
    if kv_len is not None:
        valid = (torch.arange(sk, device=device)[None, :]
                 < kv_len.reshape(-1, 1))
        valid = valid.reshape((valid.shape[0],) + (1,) * (lead + 1) + (sk,))
        mask = valid if mask is None else (mask & valid)
    return mask


def _attn_block(q, k, v, scale, causal, q_offset, kv_len):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], causal, q_offset, kv_len, q.device,
                 lead=1)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _attn_block_grouped(q, k, v, scale, causal, q_offset, kv_len):
    """GQA without repeated K/V: q folded to (B, Sq, KV, G, hd) and
    contracted against the raw (B, Sk, KV, hd) cache."""
    B, sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, sq, KV, H // KV, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = _mask(sq, k.shape[1], causal, q_offset, kv_len, q.device, lead=2)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return o.reshape(B, sq, H, hd)


def attn_apply(
    p,
    h: torch.Tensor,            # (B, S, D) — normed input
    ctx: Ctx,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = True,        # False: encoder self-attention
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention. Returns (out, updated_cache).

    Cache layout: {"k": (B, S_max, KV, hd), "v": ..., "pos": (B,) int32}.
    Prefill returns the prompt's K/V as the cache; decode writes the new
    K/V at ``pos`` into the given cache's buffers in place and returns them
    with ``pos + 1``. With ``cross_kv`` (the encoder's (B, S_enc, KV, hd)
    K/V) there is no RoPE, no K norm, no cache and no causal mask. Head
    counts come from the param shapes: the rank's where the heads are
    split (module doc), and KV the cache's.
    """
    cfg = ctx.cfg
    dt = ctx.compute_dtype
    hd = cfg.hd
    H = p["wq"].shape[1] // hd
    KV = p["wk"].shape[1] // hd
    split = ctx.splits(cfg.n_heads)
    if split and H * ctx.tp_size != cfg.n_heads:
        raise ValueError(f"wq holds {H} heads, not {cfg.n_heads} // "
                         f"{ctx.tp_size}: not this rank's block")
    hx = h.to(dt)

    q = _split_heads(hx @ p["wq"].to(dt), H, hd)
    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = _split_heads(hx @ p["wk"].to(dt), KV, hd)
        v = _split_heads(hx @ p["wv"].to(dt), KV, hd)

    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        if cross_kv is None:
            k = rms_head_norm(p["k_norm"], k)

    causal = causal and cross_kv is None
    new_cache = None
    kv_len = None

    if cross_kv is None and cfg.rope_theta > 0 and use_rope:
        assert ctx.positions is not None
        cos, sin = rope_angles(ctx.positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cross_kv is None and ctx.mode == "decode":
        assert cache is not None, "decode requires a KV cache"
        pos = cache["pos"]  # (B,) current lengths
        k_cache, v_cache = cache["k"].to(dt), cache["v"].to(dt)
        rows = torch.arange(h.shape[0], device=h.device)
        # a write past the end lands on the last slot, as the reference's
        # dynamic_update_slice clamps its start index
        at = pos.long().clamp(max=k_cache.shape[1] - 1)
        k_cache.index_put_((rows, at), k[:, 0])
        v_cache.index_put_((rows, at), v[:, 0])
        new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
        k, v = k_cache, v_cache
        kv_len = pos + 1
        causal = False  # masking handled via kv_len
    elif cross_kv is None and ctx.mode == "prefill":
        new_cache = {
            "k": k,
            "v": v,
            "pos": torch.full((h.shape[0],), h.shape[1], dtype=torch.int32,
                              device=h.device),
        }

    if split and not ctx.splits(cfg.n_kv_heads):
        k, v = _rank_kv(k, v, cfg, H)
    if kv_len is not None and ctx.attn_impl == "flash":
        # a decode self-attention: the cache as it is, each row up to its
        # length
        from repro_torch.kernels.decode_attention import ops as decode_ops

        o = decode_ops.decode_attention(q, k, v, kv_len)
    else:
        if not ctx.par.gqa_grouped:    # baseline: materialized repeat
            k = _repeat_kv(k, H // k.shape[2])
            v = _repeat_kv(v, H // v.shape[2])
        o = attention_core(q, k, v, ctx, causal=causal, kv_len=kv_len)
    o = o.reshape(h.shape[0], h.shape[1], H * hd)
    out = o @ p["wo"].to(dt)
    if split:
        out = model_sum(out)
    return out.to(h.dtype), new_cache


def cache_schema(cfg: ModelConfig, batch: int, seq: int, tp: int = 16,
                 dp_axes: Tuple[str, ...] = ("data",),
                 seq_shard: bool = False):
    """KV-cache schema for one attention layer (serving). The layout: batch
    over ``dp_axes`` where it reaches 16, else the sequence over
    ``"data"``; KV heads over ``"model"`` where they divide ``tp``, else
    (``seq_shard``, a batch of 16 or more) the sequence over ``"model"``."""
    kva = shard_axis(cfg.n_kv_heads, tp)
    if batch >= 16:
        if seq_shard and kva is None:
            kspec = pspec(dp_axes, "model", None, None)
        else:
            kspec = pspec(dp_axes, None, kva, None)
    else:
        kspec = pspec(None, "data", kva, None)
    shape = (batch, seq, cfg.n_kv_heads, cfg.hd)
    return {
        "k": PSpec(shape, kspec, dtype=torch.bfloat16, init="zeros"),
        "v": PSpec(shape, kspec, dtype=torch.bfloat16, init="zeros"),
        "pos": PSpec((batch,), dtype=torch.int32, init="zeros"),
    }
