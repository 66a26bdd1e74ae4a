"""The system under test, as the benchmark reaches it: ``repro_torch`` from
the checkout's ``src/``, its ``Server`` on the one-card mesh, its kernel
counters and its schema. Nothing else of the benchmark imports the
program."""
from __future__ import annotations

import sys
from typing import Dict

from bench.harness.spec import ROOT


def _path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def model_config(config: Dict):
    """The port's configuration named by ``config["port"]["name"]`` with
    the file's ``config["port"]["fields"]`` laid over it: the model as the
    file states it."""
    _path()
    from repro_torch.configs import get_config

    cfg = get_config(config["port"]["name"]).with_(**config["port"]["fields"])
    if cfg.padded_vocab != cfg.vocab_size:
        raise ValueError(f"{cfg.name}: padded vocabulary {cfg.padded_vocab} "
                         f"!= {cfg.vocab_size}; the benchmark's logits are "
                         "over the published vocabulary")
    return cfg


def schema_shapes(cfg) -> Dict:
    """The port's parameter tree as shapes, to hold the benchmark's layout
    against."""
    _path()
    from repro_torch.model.layers import is_pspec, tree_map
    from repro_torch.model.transformer import param_schema

    return tree_map(lambda s: tuple(s.shape), param_schema(cfg, tp=1),
                    is_leaf=is_pspec)


def new_server(cfg, params, config: Dict, slots: int, max_len: int, device,
               server_cls=None):
    _path()
    from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cls = server_cls or Server
    return cls(cfg, params, ServerConfig(batch_slots=slots, max_len=max_len,
                                         eos_token=-1, temperature=0.0),
               SMOKE_MESH,
               ParallelismConfig(**config["port"]["parallelism"]),
               device=device)


def tracer_class():
    _path()
    from repro_torch.obs import Tracer

    return Tracer


def set_tracer(tracer):
    _path()
    from repro_torch.obs import set_tracer as _set

    return _set(tracer)


def b5_launches() -> int:
    _path()
    from repro_torch.kernels.flash_attention import ops

    return ops.launches

