"""Layer-stack assembly for the dense, MoE, audio (whisper
encoder-decoder) and VLM families (port of ``repro/model/transformer.py``).

A model is a sequence of *groups* of homogeneous blocks; a group's
parameters are stacked with a leading layer axis (``params["g0"]["attn"]
["wq"]`` is ``(n_layers, d_model, H*hd)``), exactly as in the reference, so
a reference tree carries across leaf for leaf. The stack is applied as a
Python loop over layer views; in training each block runs under the
config's remat policy (``ModelConfig.remat``).

Block kinds:
  attn       - pre-norm attention + MLP (dense archs)
  attn_dense - the same, with ``moe.d_ff_dense`` (an MoE model's leading
               dense layers)
  moe        - pre-norm attention + MoE FFN (incl. shared experts)
  enc/dec    - whisper encoder (non-causal) and decoder (causal + cross)

The hybrid (Mamba-2 + shared attention) and RWKV families and
scan-over-layers wait for the slices that port them (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model import frontend as fe
from repro_torch.model import moe as moe_mod
from repro_torch.model.attention import attn_apply, attn_schema, cache_schema
from repro_torch.model.layers import (Ctx, PSpec, apply_mlp, apply_norm,
                                      checkpoint, embed_schema, embed_tokens,
                                      is_pspec, lm_logits, mlp_schema,
                                      norm_schema, tree_leaves, tree_map)

# ---------------------------------------------------------------------------
# Group structure
# ---------------------------------------------------------------------------


def group_structure(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(block_kind, count)] — the stable decomposition of the layer stack."""
    if cfg.family == "audio":
        assert cfg.encoder is not None
        return [("enc", cfg.encoder.n_layers), ("dec", cfg.n_layers)]
    if cfg.family == "moe":
        m = cfg.moe
        groups: List[Tuple[str, int]] = []
        if m.first_dense:
            groups.append(("attn_dense", m.first_dense))
        groups.append(("moe", cfg.n_layers - m.first_dense))
        return groups
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port's LM path covers the dense, "
            "moe, audio and vlm families; the hybrid and RWKV families come "
            "with ROADMAP A11's next items")
    return [("attn", cfg.n_layers)]


def block_schema(cfg: ModelConfig, kind: str):
    if kind in ("attn", "attn_dense"):
        d_ff = cfg.moe.d_ff_dense if (kind == "attn_dense"
                                      and cfg.moe) else cfg.d_ff
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg),
            "norm2": norm_schema(cfg),
            "mlp": mlp_schema(cfg, d_ff=d_ff),
        }
    if kind == "moe":
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg),
            "norm2": norm_schema(cfg),
            "moe": moe_mod.moe_schema(cfg),
        }
    if kind == "enc":
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg),
            "norm2": norm_schema(cfg),
            "mlp": mlp_schema(cfg),
        }
    if kind == "dec":
        return {
            "norm1": norm_schema(cfg),
            "self_attn": attn_schema(cfg),
            "norm2": norm_schema(cfg),
            "cross_attn": attn_schema(cfg, cross=True),
            "norm3": norm_schema(cfg),
            "mlp": mlp_schema(cfg),
        }
    raise ValueError(kind)


def _stack(n: int, tree):
    """Prepend a layer axis to every PSpec leaf."""
    return tree_map(lambda s: dataclasses.replace(s, shape=(n, *s.shape)),
                    tree, is_leaf=is_pspec)


def param_schema(cfg: ModelConfig):
    if cfg.family == "lstm":
        from repro_torch.model.lstm import lstm_schema

        return lstm_schema(cfg)
    if cfg.family == "conv1d":
        from repro_torch.model.conv1d import conv1d_schema

        return conv1d_schema(cfg)
    sch: Dict[str, Any] = {"embed": embed_schema(cfg)}
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        sch[f"g{gi}"] = _stack(count, block_schema(cfg, kind))
    if cfg.frontend:
        sch["frontend"] = fe.frontend_schema(cfg)
    if cfg.family == "audio":
        sch["enc_norm"] = norm_schema(cfg)
    sch["final_norm"] = norm_schema(cfg)
    return sch


def model_cache_schema(cfg: ModelConfig, batch: int, seq: int):
    """Cache tree for prefill/decode of ``batch`` sequences of at most
    ``seq`` positions: ``{"layers": (one entry per layer, ...)}``; an
    encoder layer's entry is None, a decoder layer's also holds the
    encoder's K/V for its cross-attention (``ck``/``cv``)."""
    layers: List[Any] = []
    for kind, count in group_structure(cfg):
        for _ in range(count):
            if kind == "enc":
                layers.append(None)           # the encoder is stateless
                continue
            c = cache_schema(cfg, batch, seq)
            if kind == "dec":
                enc = (batch, cfg.encoder.n_positions, cfg.n_kv_heads,
                       cfg.hd)
                c["ck"] = PSpec(enc, dtype=torch.bfloat16, init="zeros")
                c["cv"] = PSpec(enc, dtype=torch.bfloat16, init="zeros")
            layers.append(c)
    return {"layers": tuple(layers)}


# ---------------------------------------------------------------------------
# Block applies
# ---------------------------------------------------------------------------


def _apply_attn_block(p, x, ctx: Ctx, cache):
    a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], x, ctx.cfg),
                              ctx, cache=cache)
    x = x + a
    m = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, ctx.cfg), ctx.cfg, ctx)
    return x + m, new_cache, None


def _apply_moe_block(p, x, ctx: Ctx, cache):
    a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], x, ctx.cfg),
                              ctx, cache=cache)
    x = x + a
    m, aux = moe_mod.moe_apply(p["moe"], apply_norm(p["norm2"], x, ctx.cfg),
                               ctx.cfg, ctx)
    return x + m, new_cache, aux


def _apply_enc_block(p, x, ctx: Ctx):
    a, _ = attn_apply(p["attn"], apply_norm(p["norm1"], x, ctx.cfg), ctx,
                      causal=False)
    x = x + a
    m = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, ctx.cfg), ctx.cfg, ctx)
    return x + m


def _apply_dec_block(p, x, ctx: Ctx, cache, enc_kv):
    a, new_cache = attn_apply(p["self_attn"],
                              apply_norm(p["norm1"], x, ctx.cfg), ctx,
                              cache=cache)
    x = x + a
    c, _ = attn_apply(p["cross_attn"], apply_norm(p["norm2"], x, ctx.cfg),
                      ctx, cross_kv=enc_kv)
    x = x + c
    m = apply_mlp(p["mlp"], apply_norm(p["norm3"], x, ctx.cfg), ctx.cfg, ctx)
    return x + m, new_cache, None


def _dec_cross_kv(p_cross, enc_out, ctx: Ctx):
    """The encoder output's K/V for one decoder layer's cross-attention,
    (B, S_enc, KV, hd) each, in the compute dtype."""
    dt = ctx.compute_dtype
    hd = ctx.cfg.hd
    KV = p_cross["wk"].shape[1] // hd
    B, Se, _ = enc_out.shape
    k = (enc_out.to(dt) @ p_cross["wk"].to(dt)).reshape(B, Se, KV, hd)
    v = (enc_out.to(dt) @ p_cross["wv"].to(dt)).reshape(B, Se, KV, hd)
    return k, v


# ---------------------------------------------------------------------------
# Full model apply
# ---------------------------------------------------------------------------

REMATS = ("full", "dots", "none")


def _maybe_ckpt(fn, ctx: Ctx):
    """``fn`` under the config's remat policy in training: ``"full"``
    recomputes the block in the backward, ``"dots"`` keeps its matmuls'
    outputs and recomputes the rest, ``"none"`` keeps everything."""
    remat = ctx.cfg.remat
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} is not one of {REMATS}")
    if ctx.mode != "train" or remat == "none":
        return fn
    return checkpoint(fn, save_dots=remat == "dots")


def _layers(stacked, count: int):
    """The per-layer views of a group's stacked parameters. One ``unbind``
    a leaf, so training's backward stacks the layers' gradients once
    (a view a layer would add ``count`` full-size gradients)."""
    cols = [a.unbind(0) for a in tree_leaves(stacked)]
    for i in range(count):
        it = iter([c[i] for c in cols])
        yield tree_map(lambda _: next(it), stacked)


def _encode(params, frames: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The whisper encoder over ``frames`` (B, n_pos, frontend_dim), run as
    a prefill (or in training) with its own positions; its normed output."""
    cfg = ctx.cfg
    B, n = frames.shape[:2]
    enc_ctx = dataclasses.replace(
        ctx, mode="train" if ctx.mode == "train" else "prefill",
        positions=torch.arange(n, device=frames.device)[None].expand(B, n))
    e = fe.embed_audio(params["frontend"], frames, ctx)
    block = _maybe_ckpt(lambda p_, e_: _apply_enc_block(p_, e_, enc_ctx), ctx)
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        if kind == "enc":
            for pl in _layers(params[f"g{gi}"], count):
                e = block(pl, e)
    return apply_norm(params["enc_norm"], e, cfg)


def apply_model(
    params,
    batch: Dict[str, torch.Tensor],
    ctx: Ctx,
    cache: Optional[Dict[str, Any]] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (logits (B,S,V) f32 — or the final hidden states if
    ``return_hidden`` —, new_cache, aux). ``aux`` is the MoE blocks' summed
    load-balance loss, 0 for the other families.

    ``batch`` holds ``tokens`` and, for the frontends, ``patches`` (vlm:
    projected embeddings replace the first ``min(n_frontend_tokens, S)``
    token embeddings) or ``frames`` (audio: the encoder's input; without
    them a decoder layer takes its cross K/V from the cache)."""
    cfg = ctx.cfg
    tokens = batch["tokens"]
    B, S = tokens.shape

    if ctx.positions is None:
        if ctx.mode == "decode":
            pos0 = _decode_positions(cfg, cache)
            ctx = dataclasses.replace(ctx, positions=pos0.reshape(B, 1))
        else:
            ctx = dataclasses.replace(ctx, positions=torch.arange(
                S, device=tokens.device)[None].expand(B, S))

    x = embed_tokens(params["embed"], tokens, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.frontend == "vision" and "patches" in batch:
        vis = fe.project_vision(params["frontend"], batch["patches"], ctx)
        nf = min(cfg.n_frontend_tokens, S)   # short-sequence guard
        x = torch.cat([vis[:, :nf].to(x.dtype), x[:, nf:]], dim=1)

    enc_out = None
    if cfg.family == "audio" and "frames" in batch:
        enc_out = _encode(params, batch["frames"], ctx)

    caches = cache["layers"] if cache is not None else None
    new_layer_caches: List[Any] = []
    li = 0          # global layer index (cache slot)
    blocks = {
        "attn": _maybe_ckpt(
            lambda p_, x_, c_: _apply_attn_block(p_, x_, ctx, c_), ctx),
        "moe": _maybe_ckpt(
            lambda p_, x_, c_: _apply_moe_block(p_, x_, ctx, c_), ctx),
        "dec": _maybe_ckpt(
            lambda p_, x_, c_, kv_: _apply_dec_block(p_, x_, ctx, c_, kv_),
            ctx),
    }
    blocks["attn_dense"] = blocks["attn"]
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        if kind == "enc":                # ran above, from the frames
            li += count
            new_layer_caches.extend([None] * count)
            continue
        for pl in _layers(params[f"g{gi}"], count):
            c_in = caches[li] if caches is not None else None
            if kind == "dec":
                if enc_out is not None:
                    kvd = _dec_cross_kv(pl["cross_attn"], enc_out, ctx)
                elif c_in is not None and "ck" in c_in:
                    kvd = (c_in["ck"].to(ctx.compute_dtype),
                           c_in["cv"].to(ctx.compute_dtype))
                else:
                    raise ValueError("whisper decode needs frames or cache")
                self_c = {k: v for k, v in (c_in or {}).items()
                          if k in ("k", "v", "pos")} or None
                x, c_new, a_ = blocks["dec"](pl, x, self_c, kvd)
                if c_new is not None:
                    c_new = dict(c_new, ck=kvd[0], cv=kvd[1])
            else:
                x, c_new, a_ = blocks[kind](pl, x, c_in)
            if a_ is not None:
                aux = aux + a_
            new_layer_caches.append(c_new)
            li += 1

    x = apply_norm(params["final_norm"], x, cfg)
    logits = x if return_hidden else head_logits(params, x, ctx)
    new_cache = None
    if ctx.mode in ("prefill", "decode"):
        new_cache = {"layers": tuple(new_layer_caches)}
    return logits, new_cache, aux


def head_logits(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """LM head: (B, S, D) -> (B, S, padded_vocab) f32."""
    return lm_logits(params["embed"], x, ctx.cfg, ctx)


def pad_cache(cache, target_len: int):
    """Pad every attention KV cache in ``cache`` to ``target_len`` slots.

    Prefill returns caches sized to the prompt; decode writes new K/V at
    ``pos``, so the buffers must be pre-extended to the serving max length.
    A decoder layer's cross K/V (``ck``/``cv``) and an encoder layer's
    None pass through untouched.
    """
    def pad_entry(c):
        if not (isinstance(c, dict) and "k" in c and "v" in c):
            return c
        out = dict(c)
        for key in ("k", "v"):
            buf = c[key]
            extra = target_len - buf.shape[1]
            if extra > 0:
                out[key] = torch.nn.functional.pad(buf, (0, 0, 0, 0, 0, extra))
        return out

    return {"layers": tuple(pad_entry(c) for c in cache["layers"])}


def _decode_positions(cfg: ModelConfig, cache) -> torch.Tensor:
    """Current sequence lengths (B,) from the first attention cache."""
    ai = _first_attn_idx(cfg)
    if ai is None:
        raise ValueError(f"{cfg.name}: no attention layer tracks positions")
    return cache["layers"][ai]["pos"]


def _first_attn_idx(cfg: ModelConfig) -> Optional[int]:
    li = 0
    for kind, count in group_structure(cfg):
        if kind in ("attn", "attn_dense", "moe", "dec"):
            return li
        li += count
    return None
