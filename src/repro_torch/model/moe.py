"""Mixture-of-experts FFN on one card (port of ``repro/model/moe.py``).

The reference selects a dispatch by ``MoEConfig.impl``: ``dense`` (every
expert on every token, combined by the routing weights: the oracle),
``psum`` and ``a2a`` (expert parallelism over the mesh's ``"model"``
axis). Without a device mesh ``psum`` and ``a2a`` fall back to the dense
oracle (``moe.py:137-138``, ``:183-184``); the port runs on one card with
no mesh, so every ``impl`` runs :func:`moe_dense`, as the reference does on
one device. ``_capacity``, ``_local_expert_pass``, ``moe_psum`` and
``moe_a2a`` come with the multi-GPU slice.

The experts' products are plain matmuls, as in the reference, where they
run outside any Pallas kernel. The reference loops over the experts in
Python and stacks their outputs; :func:`moe_dense` batches the loop over
the expert axis instead (one broadcast matmul a projection, giving the
same ``(E, T, D)`` stack), which is the same arithmetic a token and an
expert.

The router's top-k takes one documented rule on every device: a stable
descending sort of the probabilities, the lowest expert index first among
equal ones. ``jax.lax.top_k`` breaks ties in an order of XLA's own, which
no rule reproduces (ROADMAP §C); on rows without ties the two agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import Ctx, PSpec, shard_axis


def moe_schema(cfg: ModelConfig, tp: int = 16):
    m = cfg.moe
    d = cfg.d_model
    ea = shard_axis(m.n_experts, tp)
    sch = {
        "router": PSpec((d, m.n_experts), dtype=torch.float32,
                        keep_dtype=True),
        "w_gate": PSpec((m.n_experts, d, m.d_expert), (ea, None, None)),
        "w_up": PSpec((m.n_experts, d, m.d_expert), (ea, None, None)),
        "w_down": PSpec((m.n_experts, m.d_expert, d), (ea, None, None)),
    }
    if m.n_shared > 0:
        fs = m.n_shared * m.d_shared
        fa = shard_axis(fs, tp)
        sch["shared"] = {
            "w_gate": PSpec((d, fs), (None, fa)),
            "w_up": PSpec((d, fs), (None, fa)),
            "wo": PSpec((fs, d), (fa, None)),
        }
    return sch


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, largest
    first; among equal entries the lowest index first (a stable
    descending sort), on every device."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x: torch.Tensor, m, dtype=torch.float32):
    """x: (T, D) -> (weights (T, k), ids (T, k), aux_loss). Router math in
    f32."""
    logits = x.to(dtype) @ p["router"].to(dtype)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, m.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e mean_prob_e * mean_frac_e;
    # the assignments per expert counted (exact in f32, and no host sync
    # as bincount's), then divided once
    ids = top_i.reshape(-1)
    frac = torch.zeros(m.n_experts, dtype=dtype, device=x.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=dtype, device=x.device)
    ) / ids.numel()
    aux = m.n_experts * torch.sum(probs.mean(0) * frac) * m.aux_loss_coef
    return top_w, top_i, aux


def _expert_ffn(xg, wg, wu, wd, dt):
    """SwiGLU expert(s): ``wg``/``wu`` (D, F) or stacked (E, D, F), ``wd``
    (F, D) or (E, F, D); stacked weights give every expert's output,
    (E, T, D)."""
    h = F.silu(xg @ wg.to(dt)) * (xg @ wu.to(dt))
    return h @ wd.to(dt)


def _shared_ffn(p, x, dt):
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["wo"].to(dt)


def moe_dense(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """(B, S, D) -> ((B, S, D), aux); every expert on every token, the
    oracle. Costs E / top_k times the routed FFN's FLOPs."""
    m = cfg.moe
    dt = ctx.compute_dtype
    b, s, d = x.shape
    xt = x.reshape(-1, d).to(dt)
    top_w, top_i, aux = _router(p, xt, m)
    # full (T, E) combine weights
    w_full = torch.zeros((xt.shape[0], m.n_experts), dtype=torch.float32,
                         device=x.device).scatter(1, top_i, top_w)
    ys = torch.einsum(
        "etd,te->td",
        _expert_ffn(xt, p["w_gate"], p["w_up"], p["w_down"], dt),
        w_full.to(dt))
    if m.n_shared > 0:
        ys = ys + _shared_ffn(p["shared"], xt, dt)
    return ys.reshape(b, s, d).to(x.dtype), aux


# With no mesh the reference's expert-parallel dispatches are moe_dense.
IMPLS = {"dense": moe_dense, "psum": moe_dense, "a2a": moe_dense}


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    impl = cfg.moe.impl
    return IMPLS[impl](p, x, cfg, ctx)
