"""Layer-stack assembly for the dense, MoE, audio (whisper
encoder-decoder), VLM, hybrid (zamba2) and RWKV families (port of
``repro/model/transformer.py``).

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
  mamba2     - pre-norm Mamba2 (zamba2 hybrid); zamba2 additionally applies
               a *shared* full attention block after every
               ``shared_attn_every``-th layer on concat(h, h_emb0) (one set
               of weights for every invocation, its own K/V cache entry
               each: the cache's ``"shared"`` tuple)
  rwkv6      - RWKV6 time-mix + channel-mix (after ``ln0`` on the
               embeddings)
  enc/dec    - whisper encoder (non-causal) and decoder (causal + cross)

The Mamba-2 and RWKV-6 blocks run the SSD (B6) and WKV6 (B7) kernels in
every CUDA prefill (``model/ssm.py``, ``model/rwkv.py``). Scan-over-layers
waits for the slice that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model import frontend as fe
from repro_torch.model import moe as moe_mod
from repro_torch.model import rwkv as rwkv_mod
from repro_torch.model import ssm as ssm_mod
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
    if cfg.family == "hybrid":
        return [("mamba2", cfg.n_layers)]
    if cfg.family == "ssm":
        return [("rwkv6", cfg.n_layers)]
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
    if kind == "mamba2":
        return {"norm1": norm_schema(cfg),
                "mamba": ssm_mod.mamba_schema(cfg)}
    if kind == "rwkv6":
        return {
            "ln1": norm_schema(cfg),
            "att": rwkv_mod.rwkv_time_schema(cfg),
            "ln2": norm_schema(cfg),
            "ffn": rwkv_mod.rwkv_channel_schema(cfg),
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


def shared_block_schema(cfg: ModelConfig):
    """zamba2 shared attention block on concat(h, emb0): width 2·d_model,
    projected back to d_model by ``out_proj``."""
    d2 = 2 * cfg.d_model
    return {
        "norm1": norm_schema(cfg, d=d2),
        "attn": attn_schema(cfg, d_in=d2, d_out=d2),
        "norm2": norm_schema(cfg, d=d2),
        "mlp": {
            "w_gate": PSpec((d2, cfg.d_ff)),
            "w_up": PSpec((d2, cfg.d_ff)),
            "wo": PSpec((cfg.d_ff, d2)),
        },
        "out_proj": PSpec((d2, cfg.d_model)),
    }


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
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        sch["shared"] = shared_block_schema(cfg)
    if cfg.family == "ssm":
        sch["ln0"] = norm_schema(cfg)
    if cfg.frontend:
        sch["frontend"] = fe.frontend_schema(cfg)
    if cfg.family == "audio":
        sch["enc_norm"] = norm_schema(cfg)
    sch["final_norm"] = norm_schema(cfg)
    return sch


def model_cache_schema(cfg: ModelConfig, batch: int, seq: int):
    """Cache tree for prefill/decode of ``batch`` sequences of at most
    ``seq`` positions: ``{"layers": (one entry per layer, ...)}``, and for
    zamba2 ``"shared"``: one attention cache per shared-block invocation.
    An encoder layer's entry is None, a decoder layer's also holds the
    encoder's K/V for its cross-attention (``ck``/``cv``), a Mamba-2 or
    RWKV-6 layer's is its recurrent state."""
    layers: List[Any] = []
    for kind, count in group_structure(cfg):
        for _ in range(count):
            layers.append(_group_cache_entry(cfg, kind, batch, seq))
    out: Dict[str, Any] = {"layers": tuple(layers)}
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        out["shared"] = tuple(cache_schema(cfg, batch, seq)
                              for _ in cfg.shared_attn_points())
    return out


def _group_cache_entry(cfg: ModelConfig, kind: str, batch: int, seq: int):
    """One layer's cache entry of block kind ``kind``."""
    if kind in ("attn", "attn_dense", "moe"):
        return cache_schema(cfg, batch, seq)
    if kind == "mamba2":
        return ssm_mod.mamba_state_schema(cfg, batch)
    if kind == "rwkv6":
        return rwkv_mod.rwkv_state_schema(cfg, batch)
    if kind == "enc":
        return None                           # the encoder is stateless
    if kind == "dec":
        c = cache_schema(cfg, batch, seq)
        enc = (batch, cfg.encoder.n_positions, cfg.n_kv_heads, cfg.hd)
        c["ck"] = PSpec(enc, dtype=torch.bfloat16, init="zeros")
        c["cv"] = PSpec(enc, dtype=torch.bfloat16, init="zeros")
        return c
    raise ValueError(kind)


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


def _apply_mamba_block(p, x, ctx: Ctx, cache):
    m, new_cache = ssm_mod.mamba_apply(
        p["mamba"], apply_norm(p["norm1"], x, ctx.cfg), ctx, state=cache)
    return x + m, new_cache, None


def _apply_rwkv_block(p, x, ctx: Ctx, cache):
    a, st_a = rwkv_mod.rwkv_time_mix(
        p["att"], apply_norm(p["ln1"], x, ctx.cfg), ctx, state=cache)
    x = x + a
    f, st_f = rwkv_mod.rwkv_channel_mix(
        p["ffn"], apply_norm(p["ln2"], x, ctx.cfg), ctx, state=cache)
    new_cache = None
    if st_a is not None or st_f is not None:
        new_cache = {**(st_a or {}), **(st_f or {})}
        if cache is not None:  # keep untouched entries (a stable tree)
            for k in cache:
                new_cache.setdefault(k, cache[k])
    return x + f, new_cache, None


def _apply_shared_block(p, x, emb0, ctx: Ctx, cache):
    """zamba2 shared attention block; input concat(h, emb0), width 2d.
    Returns (x + out_proj(block), its attention cache)."""
    u = torch.cat([x, emb0], dim=-1)
    a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], u, ctx.cfg),
                              ctx, cache=cache)
    u = u + a
    dt = ctx.compute_dtype
    un = apply_norm(p["norm2"], u, ctx.cfg).to(dt)
    mp = p["mlp"]
    h = torch.nn.functional.silu(un @ mp["w_gate"].to(dt)) * (
        un @ mp["w_up"].to(dt))
    u = u + (h @ mp["wo"].to(dt)).to(u.dtype)
    out = (u.to(dt) @ p["out_proj"].to(dt)).to(x.dtype)
    return x + out, new_cache


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
            pos0 = _decode_positions(cfg, cache, B, tokens.device)
            ctx = dataclasses.replace(ctx, positions=pos0.reshape(B, 1))
        else:
            ctx = dataclasses.replace(ctx, positions=torch.arange(
                S, device=tokens.device)[None].expand(B, S))

    x = embed_tokens(params["embed"], tokens, cfg, ctx)
    if cfg.family == "ssm":
        x = apply_norm(params["ln0"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.frontend == "vision" and "patches" in batch:
        vis = fe.project_vision(params["frontend"], batch["patches"], ctx)
        nf = min(cfg.n_frontend_tokens, S)   # short-sequence guard
        x = torch.cat([vis[:, :nf].to(x.dtype), x[:, nf:]], dim=1)

    enc_out = None
    if cfg.family == "audio" and "frames" in batch:
        enc_out = _encode(params, batch["frames"], ctx)

    emb0 = x if cfg.family == "hybrid" else None
    shared_points = set(cfg.shared_attn_points())
    caches = cache["layers"] if cache is not None else None
    shared_caches = cache.get("shared", ()) if cache is not None else ()
    new_layer_caches: List[Any] = []
    new_shared_caches: List[Any] = []
    li = 0          # global layer index (cache slot)
    si = 0          # shared-attn invocation index
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        if kind == "enc":                # ran above, from the frames
            li += count
            new_layer_caches.extend([None] * count)
            continue
        block = _maybe_ckpt(_block_apply_fn(kind, ctx), ctx)
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
                x, c_new, a_ = block(pl, x, self_c, kvd)
                if c_new is not None:
                    c_new = dict(c_new, ck=kvd[0], cv=kvd[1])
            else:
                x, c_new, a_ = block(pl, x, c_in)
            if a_ is not None:
                aux = aux + a_
            new_layer_caches.append(c_new)
            li += 1
            if (li - 1) in shared_points:
                sc_in = shared_caches[si] if shared_caches else None
                x, sc_new = _apply_shared_block(params["shared"], x, emb0,
                                                ctx, sc_in)
                new_shared_caches.append(sc_new)
                si += 1

    x = apply_norm(params["final_norm"], x, cfg)
    logits = x if return_hidden else head_logits(params, x, ctx)
    new_cache = None
    if ctx.mode in ("prefill", "decode"):
        new_cache = {"layers": tuple(new_layer_caches)}
        if new_shared_caches:
            new_cache["shared"] = tuple(new_shared_caches)
    return logits, new_cache, aux


def _block_apply_fn(kind: str, ctx: Ctx):
    """The apply of one layer of block kind ``kind`` under ``ctx``:
    ``(p, x, cache) -> (x', cache', aux or None)``; a decoder layer's also
    takes the cross K/V."""
    if kind in ("attn", "attn_dense"):
        return lambda p, x, c: _apply_attn_block(p, x, ctx, c)
    if kind == "moe":
        return lambda p, x, c: _apply_moe_block(p, x, ctx, c)
    if kind == "mamba2":
        return lambda p, x, c: _apply_mamba_block(p, x, ctx, c)
    if kind == "rwkv6":
        return lambda p, x, c: _apply_rwkv_block(p, x, ctx, c)
    if kind == "dec":
        return lambda p, x, c, kv: _apply_dec_block(p, x, ctx, c, kv)
    raise ValueError(kind)


def head_logits(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """LM head: (B, S, D) -> (B, S, padded_vocab) f32."""
    return lm_logits(params["embed"], x, ctx.cfg, ctx)


def pad_cache(cache, target_len: int):
    """Pad every attention KV cache in ``cache`` to ``target_len`` slots.

    Prefill returns caches sized to the prompt; decode writes new K/V at
    ``pos``, so the buffers must be pre-extended to the serving max length.
    A decoder layer's cross K/V (``ck``/``cv``), an encoder layer's None
    and a Mamba-2/RWKV-6 layer's state (no sequence axis) pass through
    untouched; zamba2's shared-block caches are padded as the layers'.
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

    new = {"layers": tuple(pad_entry(c) for c in cache["layers"])}
    if "shared" in cache:
        new["shared"] = tuple(pad_entry(c) for c in cache["shared"])
    return new


def _decode_positions(cfg: ModelConfig, cache, B: int,
                      device) -> torch.Tensor:
    """Current sequence lengths (B,) from whichever cache entry tracks
    them: the first attention layer's, else the first shared block's
    (zamba2); zeros for a model without attention (rwkv: positions
    unused)."""
    ai = _first_attn_idx(cfg)
    if ai is not None:
        return cache["layers"][ai]["pos"]
    if cache.get("shared"):
        return cache["shared"][0]["pos"]
    return torch.zeros((B,), dtype=torch.int32, device=device)


def _first_attn_idx(cfg: ModelConfig) -> Optional[int]:
    li = 0
    for kind, count in group_structure(cfg):
        if kind in ("attn", "attn_dense", "moe", "dec"):
            return li
        li += count
    return None
