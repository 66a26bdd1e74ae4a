"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The reference's functional update over a parameter tree, not
``torch.optim.AdamW`` (whose clipping, bias correction and order of
arithmetic differ): the optimizer state is a tree with the structure of the
parameters, all optimizer math runs in f32 on the parameters' device, and
every constant enters as the reference's weakly typed f32 does. The ZeRO
sharding of the state (the reference's ``opt_state_schema``) comes with the
multi-GPU slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.model.layers import tree_leaves, tree_map


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's order
    (dict keys sorted, as ``jax.tree.leaves`` visits them)."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: (params', opt_state', {"gnorm", "lr"}); ``grads`` has the
    structure of ``params``. New tensors throughout; nothing in place."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal and a product
    # in torch
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

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
