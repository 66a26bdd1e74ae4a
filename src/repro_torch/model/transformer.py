"""Layer-stack assembly for the dense, MoE, audio (whisper
encoder-decoder), VLM, hybrid (zamba2) and RWKV families (port of
``repro/model/transformer.py``).

A model is a sequence of *groups* of homogeneous blocks; a group's
parameters are stacked with a leading layer axis (``params["g0"]["attn"]
["wq"]`` is ``(n_layers, d_model, H*hd)``), exactly as in the reference, so
a reference tree carries across leaf for leaf. The stack is applied as a
Python loop over layer views; in training each block runs under the
config's remat policy (``ModelConfig.remat``).

``ParallelismConfig.scan_layers`` selects the reference's scan-over-layers
form. PyTorch has no compile to save, so the scan is the same loop over the
same views, with the same numbers; what differs is the serving cache,
stacked a group at a time (``{"g0": ..., "shared": ...}``, each leaf with a
leading layer axis) where the unrolled form keeps a tuple of layers
(``{"layers": ...}``), and, for zamba2, the remat unit (:func:`_runs`):
``shared_attn_every`` Mamba-2 layers and the shared block.

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

In a serving forward (prefill or decode) the attention, MoE and decoder
blocks record their attention half (norm, attention, residual) as a
``model.attn`` span and their feed-forward half as ``model.mlp``, each with
its ``layer``, on the process tracer, timed on the device too; training
records none.

The Mamba-2 and RWKV-6 blocks run the SSD (B6) and WKV6 (B7) kernels in
every CUDA prefill (``model/ssm.py``, ``model/rwkv.py``).

Every schema builder takes the reference's ``tp`` (the ``"model"`` axis
size) and gives each leaf the reference's layout (``PSpec.pspec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import SMOKE_MESH, MeshConfig, ModelConfig
from repro_torch.model import frontend as fe
from repro_torch.model import moe as moe_mod
from repro_torch.model import rwkv as rwkv_mod
from repro_torch.model import ssm as ssm_mod
from repro_torch.model.attention import attn_apply, attn_schema, cache_schema
from repro_torch.model.layers import (Ctx, PSpec, apply_mlp, apply_norm,
                                      checkpoint, embed_schema, embed_tokens,
                                      head_split, lm_logits, mlp_schema,
                                      model_sum, norm_schema,
                                      pspec, tree_leaves, tree_map,
                                      tree_map_pspec)
from repro_torch.obs import Tracer, get_tracer

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


def block_schema(cfg: ModelConfig, kind: str, tp: int = 16):
    if kind in ("attn", "attn_dense"):
        d_ff = cfg.moe.d_ff_dense if (kind == "attn_dense"
                                      and cfg.moe) else cfg.d_ff
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg, tp),
            "norm2": norm_schema(cfg),
            "mlp": mlp_schema(cfg, d_ff=d_ff, tp=tp),
        }
    if kind == "moe":
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg, tp),
            "norm2": norm_schema(cfg),
            "moe": moe_mod.moe_schema(cfg, tp),
        }
    if kind == "mamba2":
        return {"norm1": norm_schema(cfg),
                "mamba": ssm_mod.mamba_schema(cfg, tp)}
    if kind == "rwkv6":
        return {
            "ln1": norm_schema(cfg),
            "att": rwkv_mod.rwkv_time_schema(cfg, tp),
            "ln2": norm_schema(cfg),
            "ffn": rwkv_mod.rwkv_channel_schema(cfg, tp),
        }
    if kind == "enc":
        return {
            "norm1": norm_schema(cfg),
            "attn": attn_schema(cfg, tp),
            "norm2": norm_schema(cfg),
            "mlp": mlp_schema(cfg, tp=tp),
        }
    if kind == "dec":
        return {
            "norm1": norm_schema(cfg),
            "self_attn": attn_schema(cfg, tp),
            "norm2": norm_schema(cfg),
            "cross_attn": attn_schema(cfg, tp, cross=True),
            "norm3": norm_schema(cfg),
            "mlp": mlp_schema(cfg, tp=tp),
        }
    raise ValueError(kind)


def shared_block_schema(cfg: ModelConfig, tp: int = 16):
    """zamba2 shared attention block on concat(h, emb0): width 2·d_model,
    projected back to d_model by ``out_proj``."""
    d2 = 2 * cfg.d_model
    fa = "model" if cfg.d_ff % tp == 0 and tp > 1 else None
    return {
        "norm1": norm_schema(cfg, d=d2),
        "attn": attn_schema(cfg, tp, d_in=d2, d_out=d2),
        "norm2": norm_schema(cfg, d=d2),
        "mlp": {
            "w_gate": PSpec((d2, cfg.d_ff), (None, fa)),
            "w_up": PSpec((d2, cfg.d_ff), (None, fa)),
            "wo": PSpec((cfg.d_ff, d2), (fa, None)),
        },
        "out_proj": PSpec((d2, cfg.d_model)),
    }


def _stack(n: int, tree):
    """Prepend a layer axis (replicated) to every PSpec leaf."""
    return tree_map_pspec(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), pspec=(None, *s.pspec)), tree)


def param_schema(cfg: ModelConfig, tp: int = 16):
    if cfg.family == "lstm":
        from repro_torch.model.lstm import lstm_schema

        return lstm_schema(cfg)
    if cfg.family == "conv1d":
        from repro_torch.model.conv1d import conv1d_schema

        return conv1d_schema(cfg)
    sch: Dict[str, Any] = {"embed": embed_schema(cfg, tp)}
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        sch[f"g{gi}"] = _stack(count, block_schema(cfg, kind, tp))
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        sch["shared"] = shared_block_schema(cfg, tp)
    if cfg.family == "ssm":
        sch["ln0"] = norm_schema(cfg)
    if cfg.frontend:
        sch["frontend"] = fe.frontend_schema(cfg)
    if cfg.family == "audio":
        sch["enc_norm"] = norm_schema(cfg)
    sch["final_norm"] = norm_schema(cfg)
    return sch


def model_cache_schema(cfg: ModelConfig, batch: int, seq: int,
                       mesh_cfg: Optional[MeshConfig] = None, tp: int = 16,
                       stacked: bool = False, seq_shard: bool = False):
    """Cache tree for prefill/decode of ``batch`` sequences of at most
    ``seq`` positions, laid out over ``mesh_cfg`` (None: ``SMOKE_MESH``):
    ``{"layers": (one entry per layer, ...)}``, and for zamba2
    ``"shared"``: one attention cache per shared-block invocation. An
    encoder layer's entry is None, a decoder layer's also holds the
    encoder's K/V for its cross-attention (``ck``/``cv``), a Mamba-2 or
    RWKV-6 layer's is its recurrent state.

    ``stacked=True`` gives the scan-over-layers layout: one entry per group
    with a leading layer axis (``{"g0": ..., "shared": ...}``, the shared
    block's caches in invocation order) in place of the tuple."""
    mesh_cfg = mesh_cfg or SMOKE_MESH
    if stacked:
        return _stacked_cache_schema(cfg, batch, seq, mesh_cfg, tp,
                                     seq_shard)
    layers: List[Any] = []
    for kind, count in group_structure(cfg):
        layers.extend(_group_cache_entry(cfg, kind, batch, seq, mesh_cfg,
                                         tp, seq_shard)
                      for _ in range(count))
    out: Dict[str, Any] = {"layers": tuple(layers)}
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        out["shared"] = tuple(cache_schema(cfg, batch, seq, tp,
                                           mesh_cfg.dp_axes)
                              for _ in cfg.shared_attn_points())
    return out


def _group_cache_entry(cfg: ModelConfig, kind: str, batch: int, seq: int,
                       mesh_cfg: MeshConfig, tp: int,
                       seq_shard: bool = False):
    """One layer's cache entry of block kind ``kind``."""
    dp = mesh_cfg.dp_axes
    if kind in ("attn", "attn_dense", "moe"):
        return cache_schema(cfg, batch, seq, tp, dp, seq_shard=seq_shard)
    if kind == "mamba2":
        return ssm_mod.mamba_state_schema(cfg, batch, dp, tp)
    if kind == "rwkv6":
        return rwkv_mod.rwkv_state_schema(cfg, batch, dp, tp)
    if kind == "enc":
        return None                           # the encoder is stateless
    if kind == "dec":
        c = cache_schema(cfg, batch, seq, tp, dp, seq_shard=seq_shard)
        enc = (batch, cfg.encoder.n_positions, cfg.n_kv_heads, cfg.hd)
        kspec = c["k"].pspec
        layout = (kspec[0] if batch >= 16 else None, None, kspec[2], None)
        c["ck"] = PSpec(enc, layout, dtype=torch.bfloat16, init="zeros")
        c["cv"] = PSpec(enc, layout, dtype=torch.bfloat16, init="zeros")
        return c
    raise ValueError(kind)


def _stacked_cache_schema(cfg: ModelConfig, batch: int, seq: int,
                          mesh_cfg: MeshConfig, tp: int,
                          seq_shard: bool = False):
    out: Dict[str, Any] = {}
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        entry = _group_cache_entry(cfg, kind, batch, seq, mesh_cfg, tp,
                                   seq_shard)
        out[f"g{gi}"] = None if entry is None else _stack(count, entry)
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        out["shared"] = _stack(len(cfg.shared_attn_points()),
                               cache_schema(cfg, batch, seq, tp,
                                            mesh_cfg.dp_axes))
    return out


# ---------------------------------------------------------------------------
# Block applies
# ---------------------------------------------------------------------------


#: the tracer of a forward that records no spans (training, remat)
_UNTRACED = Tracer(enabled=False)


def _apply_attn_block(p, x, ctx: Ctx, cache, trc: Tracer = _UNTRACED,
                      layer: int = 0):
    cfg = ctx.cfg
    with trc.span("model.attn", device=x.device, layer=layer):
        a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], x, cfg),
                                  ctx, cache=cache)
        x = ctx.constrain(x + a)
    # an MoE model's dense blocks are its leading ``attn_dense`` layers
    d_ff = cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff
    with trc.span("model.mlp", device=x.device, layer=layer):
        m = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg, ctx,
                      d_ff)
        x = ctx.constrain(x + m)
    return x, new_cache, None


def _apply_moe_block(p, x, ctx: Ctx, cache, trc: Tracer = _UNTRACED,
                     layer: int = 0):
    with trc.span("model.attn", device=x.device, layer=layer):
        a, new_cache = attn_apply(p["attn"],
                                  apply_norm(p["norm1"], x, ctx.cfg),
                                  ctx, cache=cache)
        x = ctx.constrain(x + a)
    with trc.span("model.mlp", device=x.device, layer=layer):
        m, aux = moe_mod.moe_apply(p["moe"],
                                   apply_norm(p["norm2"], x, ctx.cfg),
                                   ctx.cfg, ctx)
        x = ctx.constrain(x + m)
    return x, new_cache, aux


def _apply_mamba_block(p, x, ctx: Ctx, cache):
    m, new_cache = ssm_mod.mamba_apply(
        p["mamba"], apply_norm(p["norm1"], x, ctx.cfg), ctx, state=cache)
    return ctx.constrain(x + m), new_cache, None


def _apply_rwkv_block(p, x, ctx: Ctx, cache):
    a, st_a = rwkv_mod.rwkv_time_mix(
        p["att"], apply_norm(p["ln1"], x, ctx.cfg), ctx, state=cache)
    x = ctx.constrain(x + a)
    f, st_f = rwkv_mod.rwkv_channel_mix(
        p["ffn"], apply_norm(p["ln2"], x, ctx.cfg), ctx, state=cache)
    new_cache = None
    if st_a is not None or st_f is not None:
        new_cache = {**(st_a or {}), **(st_f or {})}
        if cache is not None:  # keep untouched entries (a stable tree)
            for k in cache:
                new_cache.setdefault(k, cache[k])
    return ctx.constrain(x + f), new_cache, None


def _apply_shared_block(p, x, emb0, ctx: Ctx, cache):
    """zamba2 shared attention block; input concat(h, emb0), width 2d.
    Returns (x + out_proj(block), its attention cache). Where the step
    computes split, its attention runs on the rank's heads (``attn_apply``)
    and its MLP on the rank's ``d_ff`` columns where they split, each
    summed over ``"model"`` (``shared_block_schema``'s layouts);
    ``out_proj`` runs whole on the summed ``u``."""
    u = torch.cat([x, emb0], dim=-1)
    a, new_cache = attn_apply(p["attn"], apply_norm(p["norm1"], u, ctx.cfg),
                              ctx, cache=cache)
    u = u + a
    dt = ctx.compute_dtype
    un = apply_norm(p["norm2"], u, ctx.cfg).to(dt)
    mp = p["mlp"]
    h = torch.nn.functional.silu(un @ mp["w_gate"].to(dt)) * (
        un @ mp["w_up"].to(dt))
    m = h @ mp["wo"].to(dt)
    if ctx.splits(ctx.cfg.d_ff):
        m = model_sum(m)
    u = u + m.to(u.dtype)
    out = (u.to(dt) @ p["out_proj"].to(dt)).to(x.dtype)
    return ctx.constrain(x + out), new_cache


def _apply_enc_block(p, x, ctx: Ctx):
    a, _ = attn_apply(p["attn"], apply_norm(p["norm1"], x, ctx.cfg), ctx,
                      causal=False)
    x = ctx.constrain(x + a)
    m = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, ctx.cfg), ctx.cfg, ctx)
    return ctx.constrain(x + m)


def _apply_dec_block(p, x, ctx: Ctx, cache, enc_kv,
                     trc: Tracer = _UNTRACED, layer: int = 0):
    with trc.span("model.attn", device=x.device, layer=layer):
        a, new_cache = attn_apply(p["self_attn"],
                                  apply_norm(p["norm1"], x, ctx.cfg), ctx,
                                  cache=cache)
        x = ctx.constrain(x + a)
        c, _ = attn_apply(p["cross_attn"],
                          apply_norm(p["norm2"], x, ctx.cfg), ctx,
                          cross_kv=enc_kv)
        x = ctx.constrain(x + c)
    with trc.span("model.mlp", device=x.device, layer=layer):
        m = apply_mlp(p["mlp"], apply_norm(p["norm3"], x, ctx.cfg), ctx.cfg,
                      ctx)
        x = ctx.constrain(x + m)
    return x, new_cache, None


def _dec_inputs(pl, enc_out, c_in, ctx: Ctx):
    """A decoder layer's cross K/V (from the encoder's output, else from
    its cache entry) and its self-attention cache."""
    if enc_out is not None:
        kvd = _dec_cross_kv(pl["cross_attn"], enc_out, ctx)
    elif c_in is not None and "ck" in c_in:
        kvd = (c_in["ck"].to(ctx.compute_dtype),
               c_in["cv"].to(ctx.compute_dtype))
    else:
        raise ValueError("whisper decode needs frames or cache")
    self_c = {k: v for k, v in (c_in or {}).items()
              if k in ("k", "v", "pos")} or None
    return kvd, self_c


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
    block = lambda p_, e_: _apply_enc_block(p_, e_, enc_ctx)  # noqa: E731
    if not ctx.par.scan_layers:
        block = _maybe_ckpt(block, ctx)
    elif ctx.mode == "train" and cfg.remat != "none":
        block = checkpoint(block)     # the scan body, as the reference's
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
    them a decoder layer takes its cross K/V from the cache).

    Under ``ctx.par.scan_layers`` the cache given and returned is in the
    stacked layout (``model_cache_schema(stacked=True)``): the loop reads
    each layer's views of it, a tick writes each layer's new entries into
    them (:func:`_write`) and returns the cache it was given, and a prefill
    stacks each group once (:func:`_stack_groups`)."""
    cfg = ctx.cfg
    tokens = batch["tokens"]
    B, S = tokens.shape
    stacked = ctx.par.scan_layers

    if ctx.positions is None:
        if ctx.mode == "decode":
            pos0 = _decode_positions(cfg, cache, B, tokens.device,
                                     stacked=stacked)
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
    shared_at = {l: i for i, l in enumerate(cfg.shared_attn_points())}
    if cache is None:
        caches = shared_caches = None
    elif stacked:
        caches, shared_caches = _layer_views(cfg, cache)
    else:
        caches, shared_caches = cache["layers"], cache.get("shared")
    # a serving forward's attention and MLP halves are spans of the
    # process tracer (read once a forward); training records none
    trc = get_tracer() if ctx.mode in ("prefill", "decode") else _UNTRACED
    kinds: List[str] = []
    p_layers: List[Any] = []
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        kinds.extend([kind] * count)
        p_layers.extend([None] * count if kind == "enc"
                        else _layers(params[f"g{gi}"], count))

    def run_layers(lo: int, hi: int, x, whole: bool):
        """Layers ``lo``..``hi - 1``, each followed by the shared block at
        a shared point: (x', each layer's (cache, shared cache, aux)).
        ``whole``: the run is under one checkpoint, its layers under none
        of their own."""
        out = []
        for l in range(lo, hi):
            kind = kinds[l]
            if kind == "enc":                # ran above, from the frames
                out.append((None, None, None))
                continue
            block = _block_apply_fn(kind, ctx, trc, l)
            if not whole:
                block = _maybe_ckpt(block, ctx)
            pl = p_layers[l]
            c_in = caches[l] if caches is not None else None
            if kind == "dec":
                kvd, self_c = _dec_inputs(pl, enc_out, c_in, ctx)
                x, c_new, a_ = block(pl, x, self_c, kvd)
                if c_new is not None:
                    c_new = dict(c_new, ck=kvd[0], cv=kvd[1])
            else:
                x, c_new, a_ = block(pl, x, c_in)
            sc_new = None
            if l in shared_at:
                sc_in = (shared_caches[shared_at[l]] if shared_caches
                         else None)
                x, sc_new = _apply_shared_block(params["shared"], x, emb0,
                                                ctx, sc_in)
            out.append((c_new, sc_new, a_))
        return x, out

    new_layer_caches: List[Any] = []
    new_shared_caches: List[Any] = []
    for lo, hi, whole in _runs(cfg, ctx, len(kinds)):
        x, out = (checkpoint(run_layers) if whole else run_layers)(
            lo, hi, x, whole)
        for l, (c_new, sc_new, a_) in zip(range(lo, hi), out):
            if a_ is not None:
                aux = aux + a_
            if stacked and ctx.mode == "decode":   # a layer at a time
                _write(caches[l], c_new)
                if l in shared_at:
                    _write(shared_caches[shared_at[l]], sc_new)
                continue
            new_layer_caches.append(c_new)
            if l in shared_at:
                new_shared_caches.append(sc_new)

    x = apply_norm(params["final_norm"], x, cfg)
    logits = x if return_hidden else head_logits(params, x, ctx)
    new_cache = None
    if stacked and ctx.mode == "decode":
        new_cache = cache
    elif stacked and ctx.mode == "prefill":
        new_cache = _stack_groups(cfg, new_layer_caches, new_shared_caches)
    elif ctx.mode in ("prefill", "decode"):
        new_cache = {"layers": tuple(new_layer_caches)}
        if new_shared_caches:
            new_cache["shared"] = tuple(new_shared_caches)
    return logits, new_cache, aux


def _block_apply_fn(kind: str, ctx: Ctx, trc: Tracer, layer: int):
    """The apply of layer ``layer``, of block kind ``kind``, under ``ctx``:
    ``(p, x, cache) -> (x', cache', aux or None)``; a decoder layer's also
    takes the cross K/V. The attention and decoder blocks record their
    halves on ``trc`` (``model.attn``, ``model.mlp``)."""
    if kind in ("attn", "attn_dense"):
        return lambda p, x, c: _apply_attn_block(p, x, ctx, c, trc, layer)
    if kind == "moe":
        return lambda p, x, c: _apply_moe_block(p, x, ctx, c, trc, layer)
    if kind == "mamba2":
        return lambda p, x, c: _apply_mamba_block(p, x, ctx, c)
    if kind == "rwkv6":
        return lambda p, x, c: _apply_rwkv_block(p, x, ctx, c)
    if kind == "dec":
        return lambda p, x, c, kv: _apply_dec_block(p, x, ctx, c, kv, trc,
                                                    layer)
    raise ValueError(kind)


def _runs(cfg: ModelConfig, ctx: Ctx, n: int) -> List[Tuple[int, int, bool]]:
    """The runs of layers ``[lo, hi)`` that one call of the layer loop
    applies, and whether the run is checkpointed whole: one layer each,
    except zamba2's scan form in training, which runs each unit
    (``shared_attn_every`` Mamba-2 layers and the shared block) under one
    checkpoint, the reference's remat granularity, and the remaining
    layers one by one."""
    lo, runs = 0, []
    if (ctx.par.scan_layers and cfg.family == "hybrid"
            and ctx.mode == "train" and cfg.remat != "none"):
        for _ in cfg.shared_attn_points():
            runs.append((lo, lo + cfg.shared_attn_every, True))
            lo += cfg.shared_attn_every
    runs.extend((l, l + 1, False) for l in range(lo, n))
    return runs


def _layer_views(cfg: ModelConfig, cache):
    """A stacked cache's per-layer views, in layer order (an encoder
    layer's None), and the shared block's, one per invocation."""
    layers: List[Any] = []
    for gi, (_, count) in enumerate(group_structure(cfg)):
        g = cache.get(f"g{gi}")
        for l in range(count):
            layers.append(None if g is None
                          else tree_map(lambda a: a[l], g))
    sh = cache.get("shared")
    shared = None if sh is None else [
        tree_map(lambda a: a[u], sh)
        for u in range(len(cfg.shared_attn_points()))]
    return layers, shared


def _write(view, entry) -> None:
    """A layer's new cache ``entry`` written into ``view``, its slice of
    the stacked cache, where the layer did not already write it there in
    place (attention's K/V): a tick copies no cache whole."""
    def one(dst, t):
        if t.data_ptr() != dst.data_ptr() or t.stride() != dst.stride():
            dst.copy_(t)

    if entry is not None:
        tree_map(one, view, entry)


def _stack_groups(cfg: ModelConfig, layers: List[Any], shared: List[Any]):
    """A prefill's per-layer caches in the stacked layout, each group
    stacked once; a decoder's cross K/V in bf16, as the reference's scan
    stacks them."""
    def stack(entries):
        return tree_map(lambda *ls: torch.stack(ls), *entries)

    out: Dict[str, Any] = {}
    li = 0
    for gi, (kind, count) in enumerate(group_structure(cfg)):
        entries = layers[li:li + count]
        li += count
        if kind == "dec":
            entries = [dict(c, ck=c["ck"].to(torch.bfloat16),
                            cv=c["cv"].to(torch.bfloat16)) for c in entries]
        out[f"g{gi}"] = None if kind == "enc" else stack(entries)
    if shared:
        out["shared"] = stack(shared)
    return out


def head_logits(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """LM head: (B, S, D) -> (B, S, padded_vocab) f32, or the rank's
    vocabulary columns where the step computes them split
    (``layers.head_split``). On a mesh the reference pins the logits'
    layout (batch over the data axes, vocab over ``"model"`` where it
    divides): :meth:`Ctx.constrain`."""
    cfg = ctx.cfg
    logits = lm_logits(params["embed"], x, cfg, ctx)
    if head_split(cfg, ctx) and (logits.shape[-1] * ctx.tp_size
                                 != cfg.padded_vocab):
        raise ValueError(f"{logits.shape[-1]} vocabulary columns are not "
                         f"this rank's block of {cfg.padded_vocab}")
    if ctx.mesh is not None and ctx.mesh.size() > 1:
        va = "model" if cfg.padded_vocab % ctx.tp_size == 0 else None
        logits = ctx.constrain(logits, pspec(ctx.dp, None, va))
    return logits


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


def _decode_positions(cfg: ModelConfig, cache, B: int, device,
                      stacked: bool = False) -> torch.Tensor:
    """Current sequence lengths (B,) from whichever cache entry tracks
    them: the first attention layer's, else the first shared block's
    (zamba2); zeros for a model without attention (rwkv: positions
    unused). ``stacked``: the scan layout's, copied, since the tick then
    writes each layer's new position into that buffer."""
    if stacked:
        for gi, (kind, _) in enumerate(group_structure(cfg)):
            if kind in ("attn", "attn_dense", "moe", "dec"):
                return cache[f"g{gi}"]["pos"][0].clone()
        if "shared" in cache:
            return cache["shared"]["pos"][0].clone()
        return torch.zeros((B,), dtype=torch.int32, device=device)
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
