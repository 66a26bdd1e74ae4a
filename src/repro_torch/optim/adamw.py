"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The reference's functional update over a parameter tree, not
``torch.optim.AdamW`` (whose clipping, bias correction and order of
arithmetic differ): the optimizer state is a tree with the structure of the
parameters, all optimizer math runs in f32 on the parameters' device, and
every constant enters as the reference's weakly typed f32 does.
:func:`adamw_update_` is the same update written into the buffers it is
given, the port's stand-in for the reference trainer's donation to
``jax.jit``. The ZeRO sharding of the state (the reference's
``opt_state_schema`` given a mesh) comes with the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.model.layers import PSpec, is_pspec, tree_leaves, tree_map


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
    f32 zero moments and an int32 step. The reference's ZeRO-1 shards
    each moment over the data axes of ``mesh_cfg``; on one card every
    tensor is whole and ``mesh_cfg`` is not read: ZeRO comes with the
    multi-GPU slice, as ``torch.distributed``."""
    def moments():
        return tree_map(lambda s: dataclasses.replace(
            s, dtype=torch.float32, init="zeros"), param_schema_tree,
            is_leaf=is_pspec)

    return {"mu": moments(), "nu": moments(),
            "step": PSpec((), dtype=torch.int32, init="zeros")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's order
    (dict keys sorted, as ``jax.tree.leaves`` visits them)."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _scalars(grads, step: torch.Tensor, cfg: AdamWConfig):
    """(lr, gnorm, clip scale, bc1, bc2) of the step numbered ``step``."""
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal and a product
    # in torch
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    return lr, gnorm, scale, bc1, bc2


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: (params', opt_state', {"gnorm", "lr"}); ``grads`` has the
    structure of ``params``. New tensors throughout; nothing in place."""
    step = opt_state["step"] + 1
    lr, gnorm, scale, bc1, bc2 = _scalars(grads, step, cfg)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        nhat = nu / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        # decoupled weight decay — skip 1-d tensors (norms, biases)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        newp = p.to(torch.float32) * (1 - lr * wd) - lr * delta
        return newp.to(p.dtype), mu, nu

    out = [upd(*leaves) for leaves in zip(*(tree_leaves(t) for t in (
        params, grads, opt_state["mu"], opt_state["nu"])))]

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
