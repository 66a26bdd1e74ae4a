"""Mixture-of-experts FFN with expert parallelism over the mesh's
``"model"`` axis (port of ``repro/model/moe.py``).

Three dispatches, selected by ``MoEConfig.impl``:

- ``dense``: every expert on every token, combined by the routing weights:
  the oracle. The reference loops over the experts in Python and stacks
  their outputs; :func:`moe_dense` batches the loop over the expert axis
  (one broadcast matmul a projection, the same ``(E, T, D)`` stack).
- ``psum``: activations stay replicated over ``"model"``; each rank runs
  its ``n_local`` experts on the tokens routed to them (each expert's
  ``_capacity`` highest-weighted tokens), and the partial outputs are
  summed over ``"model"``.
- ``a2a``: the tokens are split over ``"model"``, routed, sent to their
  expert's rank with ``all_to_all`` (``_capacity`` x ``top_k`` slots a
  destination), computed, sent back and gathered.

``psum`` and ``a2a`` run in a ``shardmap.shard_map`` region with the
reference's specs: the expert leaves enter as ``("model", None, None)``,
so a rank computes only its own experts. Without a mesh, or where the
experts do not divide the model axis, they fall back as the reference's
do (``moe_psum`` to :func:`moe_dense`, ``moe_a2a`` to :func:`moe_psum`).
Both drop the assignments over capacity, as the reference's do. The
shared experts run beside every impl as the MLP does: where the step
computes split (``Ctx.split``), each rank its columns of their width and
a ``psum`` over ``"model"``.

The router's top-k (and the capacity selections) take one documented
rule on every device: a stable descending sort, the lowest index first
among equal values. ``jax.lax.top_k`` breaks ties in an order of XLA's
own, which no rule reproduces (ROADMAP §C5); on rows without ties the two
agree. At a capacity boundary a tie between two tokens' weights may keep
a different token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import shardmap as sm
from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import Ctx, PSpec, model_sum, shard_axis
from repro_torch.shardmap import P


def moe_schema(cfg: ModelConfig, tp: int = 16):
    m = cfg.moe
    d = cfg.d_model
    ea = shard_axis(m.n_experts, tp)
    sch = {
        "router": PSpec((d, m.n_experts), dtype=torch.float32,
                        keep_dtype=True),
        "w_gate": PSpec((m.n_experts, d, m.d_expert), (ea, None, None),
                        experts=True),
        "w_up": PSpec((m.n_experts, d, m.d_expert), (ea, None, None),
                      experts=True),
        "w_down": PSpec((m.n_experts, m.d_expert, d), (ea, None, None),
                        experts=True),
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


def _router(p, x: torch.Tensor, m, dtype=torch.float32, dp=()):
    """x: (T, D) -> (weights (T, k), ids (T, k), aux_loss). Router math in
    f32. ``dp``: data axes manual in the current region over which ``x``
    is cut: the load-balance statistics are the whole batch's, averaged
    over them (equal shards), as the reference's XLA computes them on its
    global batch."""
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
    mean_p = probs.mean(0)
    if dp:
        mean_p, frac = sm.pmean(mean_p, dp), sm.pmean(frac, dp)
    aux = m.n_experts * torch.sum(mean_p * frac) * m.aux_loss_coef
    return top_w, top_i, aux


def _cut_over(ctx: Ctx) -> tuple:
    """The data axes the current region cuts the batch over (none under
    ``grad_compression``, whose reference is manual over them too)."""
    r = sm.current_region()
    if ctx.mesh is None or r is None:
        return ()
    return tuple(a for a in ctx.dp if a in r.manual)


def _expert_ffn(xg, wg, wu, wd, dt):
    """SwiGLU expert(s): ``wg``/``wu`` (D, F) or stacked (E, D, F), ``wd``
    (F, D) or (E, F, D); stacked weights give every expert's output,
    (E, T, D)."""
    h = F.silu(xg @ wg.to(dt)) * (xg @ wu.to(dt))
    return h @ wd.to(dt)


def _shared_ffn(p, x, ctx: Ctx):
    """The shared experts' SwiGLU on a replicated ``x``: each rank's
    columns of their width and a sum over ``"model"`` where that width
    splits over it (``Ctx.splits``), as the MLP's."""
    dt = ctx.compute_dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    y = h @ p["wo"].to(dt)
    m = ctx.cfg.moe
    return model_sum(y) if ctx.splits(m.n_shared * m.d_shared) else y


def moe_dense(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """(B, S, D) -> ((B, S, D), aux); every expert on every token, the
    oracle. Costs E / top_k times the routed FFN's FLOPs. In the mesh
    train step's region over the data axes its aux loss is the whole
    batch's (``_router``'s ``dp``)."""
    m = cfg.moe
    dt = ctx.compute_dtype
    b, s, d = x.shape
    xt = x.reshape(-1, d).to(dt)
    top_w, top_i, aux = _router(p, xt, m, dp=_cut_over(ctx))
    # full (T, E) combine weights
    w_full = torch.zeros((xt.shape[0], m.n_experts), dtype=torch.float32,
                         device=x.device).scatter(1, top_i, top_w)
    ys = torch.einsum(
        "etd,te->td",
        _expert_ffn(xt, p["w_gate"], p["w_up"], p["w_down"], dt),
        w_full.to(dt))
    if m.n_shared > 0:
        ys = ys + _shared_ffn(p["shared"], xt, ctx)
    return ys.reshape(b, s, d).to(x.dtype), aux


def _capacity(n_tokens: int, m) -> int:
    per_expert = n_tokens * m.top_k / m.n_experts
    return max(4, int(per_expert * m.capacity_factor + 0.999))


# ---------------------------------------------------------------------------
# psum EP
# ---------------------------------------------------------------------------


def _local_expert_pass(xt, top_w, top_i, wg, wu, wd, e_lo, n_local, cap,
                       dt):
    """Capacity-bounded compute of ``n_local`` experts [e_lo, e_lo +
    n_local): each expert's ``cap`` highest-weighted tokens."""
    t = xt.shape[0]
    y = torch.zeros((t, xt.shape[1]), dtype=dt, device=xt.device)
    for j in range(n_local):
        e = e_lo + j
        w_e = torch.sum(torch.where(top_i == e, top_w, 0.0), dim=-1)  # (T,)
        sel_w, sel_i = top_k(w_e, min(cap, t))
        ye = _expert_ffn(xt[sel_i], wg[j], wu[j], wd[j], dt)
        y = y.index_add(0, sel_i, sel_w[:, None].to(dt) * ye)
    return y


def moe_psum(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    m = cfg.moe
    dt = ctx.compute_dtype
    b, s, d = x.shape
    mesh = ctx.mesh
    tp = ctx.tp_size
    ea = shard_axis(m.n_experts, tp)
    if mesh is None or ea is None:
        return moe_dense(p, x, cfg, ctx)
    n_local = m.n_experts // tp
    dp = ctx.dp

    def body(xt, router, wg, wu, wd):
        t = xt.shape[0] * xt.shape[1]
        xf = xt.reshape(t, d).to(dt)
        top_w, top_i, aux = _router({"router": router}, xf, m)
        cap = _capacity(t, m)
        mi = sm.axis_index("model")
        y = _local_expert_pass(xf, top_w, top_i, wg, wu, wd, mi * n_local,
                               n_local, cap, dt)
        y = sm.psum(y, "model")
        aux = sm.pmean(sm.pvary(aux, ("model",)), dp + ("model",))
        return y.reshape(xt.shape).to(xt.dtype), aux

    fn = sm.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(dp, None, None), P(), P("model", None, None),
                  P("model", None, None), P("model", None, None)),
        out_specs=(P(dp, None, None), P()),
    )
    y, aux = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if m.n_shared > 0:
        y = y + _shared_ffn(p["shared"], x.to(dt), ctx).to(x.dtype)
    return y, aux


# ---------------------------------------------------------------------------
# all_to_all EP
# ---------------------------------------------------------------------------


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    m = cfg.moe
    dt = ctx.compute_dtype
    b, s, d = x.shape
    mesh = ctx.mesh
    tp = ctx.tp_size
    ea = shard_axis(m.n_experts, tp)
    if mesh is None or ea is None or (b * s) % tp != 0:
        return moe_psum(p, x, cfg, ctx)
    n_local = m.n_experts // tp
    dp = ctx.dp

    def body(xt, router, wg, wu, wd):
        t_loc = xt.shape[0] * xt.shape[1]
        xf = xt.reshape(t_loc, d).to(dt)
        mi = sm.axis_index("model")
        t_m = t_loc // tp
        # sequence-split across the model axis: this rank's token slice
        xs = xf[mi * t_m:(mi + 1) * t_m]
        top_w, top_i, aux = _router({"router": router}, xs, m)
        # flatten the (token, k) assignments
        a_tok = torch.arange(t_m, device=xs.device).repeat_interleave(
            m.top_k)
        a_exp = top_i.reshape(-1)
        a_w = top_w.reshape(-1)
        a_dst = a_exp // n_local
        cs = _capacity(t_m, m) * max(1, m.top_k)  # per-destination slots
        cs = min(cs, t_m * m.top_k)
        send_x, send_meta, send_tok, send_w = [], [], [], []
        for dst in range(tp):
            w_d = torch.where(a_dst == dst, a_w, -1.0)
            sel_w, sel = top_k(w_d, cs)
            valid = sel_w > 0
            send_x.append(xs[a_tok[sel]] * valid[:, None])
            send_meta.append(torch.where(valid, a_exp[sel] % n_local,
                                         n_local))
            send_tok.append(a_tok[sel])
            send_w.append(torch.where(valid, sel_w, 0.0))
        sx = torch.stack(send_x)                    # (tp, cs, d)
        smeta = torch.stack(send_meta)              # (tp, cs) local ids
        # exchange tokens with the experts' owners
        rx = sm.all_to_all(sx, "model", 0, 0, tiled=False)
        rm = sm.all_to_all(smeta, "model", 0, 0, tiled=False)
        rxf = rx.reshape(tp * cs, d)
        rmf = rm.reshape(tp * cs)
        ry = torch.zeros_like(rxf)
        for j in range(n_local):
            mask = (rmf == j).to(dt)[:, None]
            ry = ry + mask * _expert_ffn(rxf, wg[j], wu[j], wd[j], dt)
        # return the outputs to the tokens' owners
        back = sm.all_to_all(ry.reshape(tp, cs, d), "model", 0, 0,
                             tiled=False)
        ys = torch.zeros((t_m, d), dtype=dt, device=xs.device)
        for dst in range(tp):
            ys = ys.index_add(0, send_tok[dst],
                              send_w[dst][:, None].to(dt) * back[dst])
        # restore model-replicated activations
        y = sm.all_gather(ys, "model", axis=0, tiled=True)
        aux = sm.pmean(aux, dp + ("model",))
        return y.reshape(xt.shape).to(xt.dtype), aux

    fn = sm.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(dp, None, None), P(), P("model", None, None),
                  P("model", None, None), P("model", None, None)),
        out_specs=(P(dp, None, None), P()),
        check_vma=False,   # all_to_all round-trip defeats replication inference
    )
    y, aux = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if m.n_shared > 0:
        y = y + _shared_ffn(p["shared"], x.to(dt), ctx).to(x.dtype)
    return y, aux


IMPLS = {"dense": moe_dense, "psum": moe_psum, "a2a": moe_a2a}


def cuts_batch(cfg: ModelConfig, tp: int) -> bool:
    """Whether the MoE's dispatch runs in a region of its own that cuts
    its tokens' batch over the data axes (``psum``, ``a2a``, with the
    experts split over a ``"model"`` axis of ``tp``): a batch that the
    axes do not divide then raises there, as the reference's
    ``shard_map`` refuses it."""
    m = cfg.moe
    return (m is not None and m.impl != "dense"
            and shard_axis(m.n_experts, tp) is not None)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    impl = cfg.moe.impl
    return IMPLS[impl](p, x, cfg, ctx)
