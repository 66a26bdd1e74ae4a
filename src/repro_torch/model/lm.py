"""Step functions, input specs and the ``Stepper`` (port of
``repro/model/lm.py``).

The step builders return plain callables: PyTorch runs eagerly, so nothing
is jit-compiled, and the LM decode step updates the cache it is given in
place. For the window families (``lstm``/``conv1d``) the loss, the train
step and the one-window "prefill" are the reference's; the LM
cross-entropy and its train step come with the LM training slice
(ROADMAP A11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.types import (MeshConfig, ModelConfig,
                                    ParallelismConfig, ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.model.layers import Ctx, init_params, value_and_grad
from repro_torch.model.transformer import (apply_model, model_cache_schema,
                                           param_schema)
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["param_schema", "make_loss_fn", "make_train_step",
           "make_prefill_step", "make_decode_step", "input_specs", "Stepper"]

WINDOW_FAMILIES = ("lstm", "conv1d")


def _mk_ctx(cfg, mesh_cfg, mode, par):
    return Ctx(cfg=cfg, mesh_cfg=mesh_cfg, mode=mode, par=par,
               attn_impl=par.attn_impl)


def _window_apply(cfg: ModelConfig):
    if cfg.family == "lstm":
        from repro_torch.model.lstm import lstm_apply as apply_fn
    else:
        from repro_torch.model.conv1d import conv1d_apply as apply_fn
    return apply_fn


def _lm_training(what: str):
    return NotImplementedError(
        f"{what} of the LM families comes with the LM training slice "
        "(ROADMAP A11: cross_entropy, chunked_ce_loss and the LM train "
        "step); the window families (lstm, conv1d) have theirs")


def make_loss_fn(cfg: ModelConfig, mesh_cfg: MeshConfig,
                 par: ParallelismConfig):
    """(params, batch) -> (loss, {"loss": loss}): the window MSE."""
    if cfg.family not in WINDOW_FAMILIES:
        raise _lm_training("the loss")
    apply_fn = _window_apply(cfg)

    def window_loss(params, batch):
        pred, _ = apply_fn(params, batch["x"], cfg)
        loss = torch.mean(torch.square(pred - batch["y"]))
        return loss, {"loss": loss}

    return window_loss


def make_train_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                    par: ParallelismConfig, opt_cfg: AdamWConfig):
    """(params, opt_state, batch) -> (params', opt_state', metrics)."""
    grad_fn = value_and_grad(make_loss_fn(cfg, mesh_cfg, par),
                             has_aux=True)

    def step(params, opt_state, batch):
        (_, metrics), grads = grad_fn(params, batch)
        new_params, new_opt, info = adamw_update(grads, opt_state, params,
                                                 opt_cfg)
        return new_params, new_opt, dict(metrics, **info)

    return step


def make_prefill_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                      par: ParallelismConfig):
    """(params, batch) -> (last_logits (B, V) f32, cache).

    For the window families "prefill" is one window inference: (params,
    batch) -> (pred (B, out_features), state), what the RTL target lowers.
    """
    if cfg.family in WINDOW_FAMILIES:
        apply_fn = _window_apply(cfg)

        def window_step(params, batch):
            return apply_fn(params, batch["x"], cfg)

        return window_step

    def step(params, batch):
        ctx = _mk_ctx(cfg, mesh_cfg, "prefill", par)
        logits, cache, _ = apply_model(params, batch, ctx)
        return logits[:, -1], cache

    return step


def make_decode_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                     par: ParallelismConfig):
    """(params, tokens (B, 1), cache) -> (logits (B, V) f32, cache'); the
    K/V buffers of ``cache`` are updated in place and returned in cache'."""

    def step(params, tokens, cache):
        ctx = _mk_ctx(cfg, mesh_cfg, "decode", par)
        logits, new_cache, _ = apply_model(params, {"tokens": tokens}, ctx,
                                           cache=cache)
        return logits[:, -1], new_cache

    return step


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in WINDOW_FAMILIES:
        c = cfg.lstm if cfg.family == "lstm" else cfg.conv1d
        d_in = c.in_features if cfg.family == "lstm" else c.channels
        return {"x": ((B, c.seq_len, d_in), torch.float32),
                "y": ((B, c.out_features), torch.float32)}
    specs = {"tokens": ((B, 1 if shape.kind == "decode" else S),
                        torch.int32)}
    if shape.kind == "train":
        specs["targets"] = ((B, S), torch.int32)
    return specs


@dataclass
class Stepper:
    """Schema and step functions of one (arch x shape) cell on one card."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh_cfg: MeshConfig
    par: ParallelismConfig
    opt_cfg: AdamWConfig = AdamWConfig()

    def __post_init__(self):
        self.schema = param_schema(self.cfg)

    def cache_schema(self):
        return model_cache_schema(self.cfg, self.shape.global_batch,
                                  self.shape.seq_len)

    def train_fn(self):
        return make_train_step(self.cfg, self.mesh_cfg, self.par,
                               self.opt_cfg)

    def prefill_fn(self):
        return make_prefill_step(self.cfg, self.mesh_cfg, self.par)

    def decode_fn(self):
        return make_decode_step(self.cfg, self.mesh_cfg, self.par)

    def init(self, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = None,
             dtype_override: Optional[torch.dtype] = None):
        """Seeded random parameters drawn on ``device`` (None means CUDA)
        by a ``torch.Generator``. Parameters only: the reference's ``init``
        also returns the optimizer state, which at Yi-9B's width (72 GB of
        f32 moments beside 18 GB of bf16 weights) would not fit on the
        card; a trainer takes it from ``optim.adamw.init_opt_state``."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(self.schema, gen, dtype_override)
