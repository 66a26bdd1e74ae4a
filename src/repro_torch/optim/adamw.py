"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The reference's functional update over a parameter tree, not
``torch.optim.AdamW`` (whose clipping, bias correction and order of
arithmetic differ): the optimizer state is a tree with the structure of the
parameters, all optimizer math runs in f32 on the parameters' device, and
every constant enters as the reference's weakly typed f32 does.
:func:`adamw_update_` is the same update written into the buffers it is
given, the port's stand-in for the reference trainer's donation to
``jax.jit``.

ZeRO-1: given a mesh, ``opt_state_schema`` shards each moment's largest
unsharded dimension that divides the data axes over them, and
:func:`adamw_update_sharded` (inside a manual region over every mesh
axis, ``shardmap.region``) updates each rank's own slices: the global
norm is summed over the ranks that hold parts of a leaf, and the updated
parameter slices are gathered back over the data axes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.model.layers import (PSpec, axes_of, is_pspec, pspec,
                                      tree_leaves, tree_map)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    # tensor divisors: a float divisor is a reciprocal and a product on
    # CUDA, a rounding away from the reference's division
    warm = s / torch.full_like(s, max(1.0, cfg.warmup_steps))
    prog = (s - cfg.warmup_steps) / torch.full_like(
        s, max(1.0, cfg.total_steps - cfg.warmup_steps))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero moments in f32 beside each parameter, and the step count."""
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_schema(param_schema_tree, mesh_cfg=None):
    """PSpec tree of the optimizer state (mirrors the parameter schema):
    f32 zero moments and an int32 step.

    ZeRO-1: when a ``mesh_cfg`` is given, each moment additionally shards
    its largest still-unsharded dimension that divides the data axes'
    size over them: the moments are touched only by the update, so this
    costs the forward and backward nothing and cuts each rank's optimizer
    bytes by |dp|."""
    dp_axes = tuple(mesh_cfg.dp_axes) if mesh_cfg is not None else ()
    dp_n = 1
    for a in dp_axes:
        dp_n *= mesh_cfg.axis_size(a)

    def zero_shard(s: PSpec) -> PSpec:
        spec = list(s.pspec) + [None] * (len(s.shape) - len(s.pspec))
        if dp_n > 1 and len(s.shape) >= 2:
            # shard the largest unsharded dim that divides the dp size
            cands = [i for i, ax in enumerate(spec) if ax is None
                     and s.shape[i] % dp_n == 0]
            if cands:
                best = max(cands, key=lambda i: s.shape[i])
                spec[best] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        return dataclasses.replace(s, dtype=torch.float32, init="zeros",
                                   pspec=pspec(*spec))

    def moments():
        return tree_map(zero_shard, param_schema_tree, is_leaf=is_pspec)

    return {"mu": moments(), "nu": moments(),
            "step": PSpec((), dtype=torch.int32, init="zeros")}


def zero_dims(param_schema_tree, mesh_cfg) -> list:
    """Per parameter leaf (in leaf order), the dim ZeRO-1 shards its
    moments along over the data axes, or None."""
    dp = set(mesh_cfg.dp_axes)

    def dim(s: PSpec):
        for i, e in enumerate(s.pspec):
            if dp & set(axes_of(e)):
                return i
        return None

    mu = opt_state_schema(param_schema_tree, mesh_cfg)["mu"]
    return [dim(s) for s in tree_leaves(mu, is_pspec)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's order
    (dict keys sorted, as ``jax.tree.leaves`` visits them)."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _scalars(grads, step: torch.Tensor, cfg: AdamWConfig, gnorm=None):
    """(lr, gnorm, clip scale, bc1, bc2) of the step numbered ``step``."""
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    # a tensor numerator: ``float / tensor`` is a reciprocal and a product
    # in torch
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    return lr, gnorm, scale, bc1, bc2


def _upd(p, g, mu, nu, lr, scale, bc1, bc2, cfg: AdamWConfig):
    g = g.to(torch.float32) * scale
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
    mhat = mu / bc1
    nhat = nu / bc2
    delta = mhat / (torch.sqrt(nhat) + cfg.eps)
    # decoupled weight decay — skip 1-d tensors (norms, biases)
    wd = cfg.weight_decay if p.ndim >= 2 else 0.0
    newp = p.to(torch.float32) * (1 - lr * wd) - lr * delta
    return newp.to(p.dtype), mu, nu


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: (params', opt_state', {"gnorm", "lr"}); ``grads`` has the
    structure of ``params``. New tensors throughout; nothing in place."""
    step = opt_state["step"] + 1
    lr, gnorm, scale, bc1, bc2 = _scalars(grads, step, cfg)
    out = [_upd(*leaves, lr, scale, bc1, bc2, cfg) for leaves in zip(
        *(tree_leaves(t) for t in (params, grads, opt_state["mu"],
                                   opt_state["nu"])))]

    def rebuild(i):
        it = iter(o[i] for o in out)
        return tree_map(lambda _: next(it), params)

    new_params, new_mu, new_nu = rebuild(0), rebuild(1), rebuild(2)
    info = {"gnorm": gnorm, "lr": lr}
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}, info


@torch.no_grad()
def adamw_update_(grads, opt_state, params, cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """:func:`adamw_update` written into the buffers it is given: returns
    ``(params, opt_state, info)``, the same objects, each parameter, moment
    and the step updated in place, and every number equal to
    :func:`adamw_update`'s bit for bit (the same elementwise ops, in the
    same order, on the same operands). ``grads`` are consumed: an f32
    gradient is the scratch of its own leaf. A leaf needs one more
    leaf-sized f32 buffer (two for a bf16 leaf), freed before the next;
    the reference's trainer gets the same from donating params and state
    to ``jax.jit``."""
    step = opt_state["step"].add_(1)
    lr, gnorm, scale, bc1, bc2 = _scalars(grads, step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    for p, g, mu, nu in zip(*(tree_leaves(t) for t in (
            params, grads, opt_state["mu"], opt_state["nu"]))):
        g = g.mul_(scale) if g.dtype == torch.float32 else (
            g.to(torch.float32) * scale)
        tmp = torch.mul(g, 1 - b1)
        mu.mul_(b1).add_(tmp)
        torch.square(g, out=tmp)
        nu.mul_(b2).add_(tmp.mul_(1 - b2))
        mhat = torch.div(mu, bc1, out=tmp)
        nhat = torch.div(nu, bc2, out=g)
        delta = mhat.div_(nhat.sqrt_().add_(cfg.eps))
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
        p32.mul_(1 - lr * wd).sub_(delta.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
        del g, tmp, mhat, nhat, delta, p32
    return params, opt_state, {"gnorm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_sharded(grads, opt_state, params, cfg: AdamWConfig, *,
                         schema, mesh_cfg, donate: bool = False
                         ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """:func:`adamw_update` on each rank's blocks, inside a manual region
    over every mesh axis. ``params``/``grads``: this rank's blocks of each
    leaf (the gradient already reduced over the data axes); ``schema``:
    the parameters' PSpec tree (each leaf's layout, and with ``mesh_cfg``
    the dim its moments are split along over the data axes,
    :func:`zero_dims`); ``opt_state``: this rank's moment slices. The global
    norm sums each leaf's squares over the ranks that hold its parts, leaf
    by leaf in the reference's order; each rank updates its moment slices
    and its slice of the parameter, and the slices are gathered back over
    the data axes. On one rank the numbers are :func:`adamw_update`'s bit
    for bit. ``donate``: the results are written into the given buffers,
    which are returned."""
    from repro_torch import shardmap as sm

    g_l = tree_leaves(grads)
    lay_l = [s.pspec for s in tree_leaves(schema, is_pspec)]
    zdims = zero_dims(schema, mesh_cfg)
    dp_axes = tuple(mesh_cfg.dp_axes)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in g_l]
    by_axes: Dict[tuple, list] = {}
    for i, lay in enumerate(lay_l):
        axes = tuple(a for e in lay for a in axes_of(e))
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        summed = sm.psum(torch.stack([sq[i] for i in idx]), axes)
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    total = None
    for v in sq:
        total = v if total is None else total + v
    step = opt_state["step"] + 1
    lr, gnorm, scale, bc1, bc2 = _scalars(None, step, cfg,
                                          gnorm=torch.sqrt(total))
    dp_n = sm.axis_size(dp_axes) if dp_axes else 1
    dp_i = sm.axis_index(dp_axes) if dp_axes else 0
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, z in zip(
            tree_leaves(params), g_l, tree_leaves(opt_state["mu"]),
            tree_leaves(opt_state["nu"]), zdims):
        if z is not None and dp_n > 1:
            size = p.shape[z] // dp_n
            ps, gs = (t.narrow(z, dp_i * size, size) for t in (p, g))
            np_s, m2, n2 = _upd(ps, gs, mu, nu, lr, scale, bc1, bc2, cfg)
            np_ = sm.all_gather(np_s, dp_axes, axis=z, tiled=True)
        else:
            np_, m2, n2 = _upd(p, g, mu, nu, lr, scale, bc1, bc2, cfg)
        if donate:
            p.copy_(np_)
            mu.copy_(m2)
            nu.copy_(n2)
            np_, m2, n2 = p, mu, nu
        new_p.append(np_)
        new_mu.append(m2)
        new_nu.append(n2)

    def rebuild(vals, like):
        it = iter(vals)
        return tree_map(lambda _: next(it), like)

    if donate:
        opt_state["step"].copy_(step)
        step = opt_state["step"]
    return (rebuild(new_p, params),
            {"mu": rebuild(new_mu, params), "nu": rebuild(new_nu, params),
             "step": step}, {"gnorm": gnorm, "lr": lr})
