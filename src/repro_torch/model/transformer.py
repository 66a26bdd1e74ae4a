"""Layer-stack assembly, the dense subset (port of
``repro/model/transformer.py``).

A model is a sequence of *groups* of homogeneous blocks; a group's
parameters are stacked with a leading layer axis (``params["g0"]["attn"]
["wq"]`` is ``(n_layers, d_model, H*hd)``), exactly as in the reference, so
a reference tree carries across leaf for leaf. The stack is applied as a
Python loop over layer views; in training each block runs under the
config's remat policy (``ModelConfig.remat``). The other families (MoE,
Mamba-2, RWKV-6, whisper, frontends) and scan-over-layers wait for the
slices that port them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.attention import attn_apply, attn_schema, cache_schema
from repro_torch.model.layers import (Ctx, apply_mlp, apply_norm,
                                      checkpoint, embed_schema, embed_tokens,
                                      is_pspec, lm_logits, mlp_schema,
                                      norm_schema, tree_leaves, tree_map)

# ---------------------------------------------------------------------------
# Group structure
# ---------------------------------------------------------------------------


def group_structure(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(block_kind, count)] — the stable decomposition of the layer stack."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port's LM path covers the dense "
            "family only so far")
    return [("attn", cfg.n_layers)]


def block_schema(cfg: ModelConfig, kind: str):
    if kind != "attn":
        raise ValueError(kind)
    return {
        "norm1": norm_schema(cfg),
        "attn": attn_schema(cfg),
        "norm2": norm_schema(cfg),
        "mlp": mlp_schema(cfg),
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
    sch["final_norm"] = norm_schema(cfg)
    return sch


def model_cache_schema(cfg: ModelConfig, batch: int, seq: int):
    """Cache tree for prefill/decode of ``batch`` sequences of at most
    ``seq`` positions: ``{"layers": (one entry per layer, ...)}``."""
    layers = [cache_schema(cfg, batch, seq)
              for _, count in group_structure(cfg) for _ in range(count)]
    return {"layers": tuple(layers)}


# ---------------------------------------------------------------------------
# Block apply + full model apply
# ---------------------------------------------------------------------------


def _apply_attn_block(p, x, ctx: Ctx, cache):
    a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], x, ctx.cfg),
                              ctx, cache=cache)
    x = x + a
    m = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, ctx.cfg), ctx.cfg, ctx)
    return x + m, new_cache


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


def apply_model(
    params,
    batch: Dict[str, torch.Tensor],
    ctx: Ctx,
    cache: Optional[Dict[str, Any]] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (logits (B,S,V) f32 — or the final hidden states if
    ``return_hidden`` —, new_cache, aux). ``aux`` is the auxiliary loss,
    0 for the dense family."""
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
    caches = cache["layers"] if cache is not None else None
    new_layer_caches: List[Any] = []
    li = 0          # global layer index (cache slot)
    block = _maybe_ckpt(lambda p_, x_, c_: _apply_attn_block(p_, x_, ctx, c_),
                        ctx)
    for gi, (_, count) in enumerate(group_structure(cfg)):
        for pl in _layers(params[f"g{gi}"], count):
            c_in = caches[li] if caches is not None else None
            x, c_new = block(pl, x, c_in)
            new_layer_caches.append(c_new)
            li += 1

    x = apply_norm(params["final_norm"], x, cfg)
    logits = x if return_hidden else head_logits(params, x, ctx)
    new_cache = None
    if ctx.mode in ("prefill", "decode"):
        new_cache = {"layers": tuple(new_layer_caches)}
    return logits, new_cache, torch.zeros((), device=x.device)


def head_logits(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """LM head: (B, S, D) -> (B, S, padded_vocab) f32."""
    return lm_logits(params["embed"], x, ctx.cfg, ctx)


def pad_cache(cache, target_len: int):
    """Pad every attention KV cache in ``cache`` to ``target_len`` slots.

    Prefill returns caches sized to the prompt; decode writes new K/V at
    ``pos``, so the buffers must be pre-extended to the serving max length.
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
        if kind == "attn":
            return li
        li += count
    return None
