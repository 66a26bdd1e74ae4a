"""Step functions, input specs and the ``Stepper`` of the dense LM (port
of the serving half of ``repro/model/lm.py``).

``make_prefill_step``/``make_decode_step`` build plain callables: PyTorch
runs eagerly, so nothing is jit-compiled, and the decode step updates the
cache it is given in place. The train step, the optimizer state and the
cross-entropy wait for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.types import (MeshConfig, ModelConfig,
                                    ParallelismConfig, ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.model.layers import Ctx, init_params
from repro_torch.model.transformer import (apply_model, model_cache_schema,
                                           param_schema)

__all__ = ["param_schema", "make_prefill_step", "make_decode_step",
           "input_specs", "Stepper"]


def _mk_ctx(cfg, mesh_cfg, mode, par):
    return Ctx(cfg=cfg, mesh_cfg=mesh_cfg, mode=mode, par=par,
               attn_impl=par.attn_impl)


def make_prefill_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                      par: ParallelismConfig):
    """(params, batch) -> (last_logits (B, V) f32, cache)."""

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
    """``{name: (shape, dtype)}`` of every token input of this cell."""
    B, S = shape.global_batch, shape.seq_len
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

    def __post_init__(self):
        self.schema = param_schema(self.cfg)

    def cache_schema(self):
        return model_cache_schema(self.cfg, self.shape.global_batch,
                                  self.shape.seq_len)

    def prefill_fn(self):
        return make_prefill_step(self.cfg, self.mesh_cfg, self.par)

    def decode_fn(self):
        return make_decode_step(self.cfg, self.mesh_cfg, self.par)

    def init(self, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = None,
             dtype_override: Optional[torch.dtype] = None):
        """Seeded random parameters drawn on ``device`` (None means CUDA)
        by a ``torch.Generator``; the reference's ``init`` also returns the
        optimizer state, which waits for the training slice."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(self.schema, gen, dtype_override)
