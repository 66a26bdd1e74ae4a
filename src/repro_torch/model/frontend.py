"""Modality frontends, stubs as in the reference (port of
``repro/model/frontend.py``).

The ``[audio]``/``[vlm]`` architectures specify the transformer backbone
only; ``lm.input_specs`` gives precomputed frame/patch embeddings. What
lives here is the learned glue: the projector from the frontend's
embedding space into the LM, and the whisper encoder's learned position
embeddings.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import Ctx, PSpec


def frontend_schema(cfg: ModelConfig):
    if cfg.frontend == "vision":
        # InternVL-style pixel-unshuffle + 2-layer MLP projector (mlp1)
        fd = cfg.frontend_dim
        return {
            "norm_scale": PSpec((fd,), init="ones"),
            "norm_bias": PSpec((fd,), init="zeros"),
            "w1": PSpec((fd, cfg.d_model)),
            "b1": PSpec((cfg.d_model,), init="zeros"),
            "w2": PSpec((cfg.d_model, cfg.d_model)),
            "b2": PSpec((cfg.d_model,), init="zeros"),
        }
    if cfg.frontend == "audio":
        # whisper: the conv stem is a stub; learned encoder positions
        assert cfg.encoder is not None
        return {
            "pos_emb": PSpec((cfg.encoder.n_positions, cfg.d_model),
                             init="embed"),
            "in_proj": PSpec((cfg.frontend_dim, cfg.d_model)),
        }
    return {}


def project_vision(p, patch_emb: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """patch_emb: (B, n_tokens, frontend_dim) -> (B, n_tokens, d_model):
    LayerNorm (population variance) in f32, then GELU (tanh form, as
    ``jax.nn.gelu``) between two affine maps in the compute dtype."""
    dt = ctx.compute_dtype
    x = patch_emb.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    x = x * p["norm_scale"].float() + p["norm_bias"].float()
    x = x.to(dt)
    h = F.gelu(x @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


def embed_audio(p, frames: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """frames: (B, n_pos, frontend_dim) precomputed -> encoder input."""
    dt = ctx.compute_dtype
    h = frames.to(dt) @ p["in_proj"].to(dt)
    return h + p["pos_emb"].to(dt)[None, : frames.shape[1]]
