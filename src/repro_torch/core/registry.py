"""Component registry — what "supported by the ElasticAI-Creator" means
(port of ``repro/core/registry.py``).

A *translatable component* carries up to three implementations:
  ref       — the plain PyTorch definition (trainable, the oracle)
  template  — the hand-written hardware template (a CUDA kernel's wrapper),
              the RTL analogue; ``None`` where plain PyTorch is enough
  quantized — fixed-point / int8 variant

``Creator.validate`` walks a model config's block kinds and fails fast if a
kind has no registered component — the paper's "models must be built from
supported components" rule, enforced mechanically. The built-in library
names the port's own modules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.types import ModelConfig


@dataclass(frozen=True)
class Component:
    name: str
    ref: str                         # dotted path of the plain reference impl
    template: Optional[str] = None   # dotted path of the kernel's wrapper
    quantized: Optional[str] = None
    notes: str = ""


_REGISTRY: Dict[str, Component] = {}


def register(c: Component) -> None:
    _REGISTRY[c.name] = c


def get(name: str) -> Component:
    if name not in _REGISTRY:
        raise KeyError(
            f"component {name!r} is not supported by the creator; "
            f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_components() -> Dict[str, Component]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in component library
# ---------------------------------------------------------------------------

register(Component(
    "attn", ref="repro_torch.model.attention.attn_apply",
    template="repro_torch.kernels.flash_attention.ops",
    quantized="repro_torch.quant.ptq",
    notes="GQA self/cross attention; flash template for causal prefill"))
register(Component(
    "attn_dense", ref="repro_torch.model.attention.attn_apply",
    template="repro_torch.kernels.flash_attention.ops"))
register(Component(
    "moe", ref="repro_torch.model.moe.moe_apply",
    notes="EP dispatch is collective-bound, no kernel template needed"))
register(Component(
    "mamba2", ref="repro_torch.model.ssm.mamba_apply",
    template="repro_torch.kernels.mamba2.ops",
    notes="SSD chunk-scan template on every CUDA prefill"))
register(Component(
    "rwkv6", ref="repro_torch.model.rwkv.rwkv_time_mix",
    template="repro_torch.kernels.rwkv6.ops",
    notes="WKV6 template on every CUDA prefill"))
register(Component(
    "enc", ref="repro_torch.model.transformer._apply_enc_block"))
register(Component(
    "dec", ref="repro_torch.model.transformer._apply_dec_block"))
register(Component(
    "lstm", ref="repro_torch.model.lstm.lstm_apply",
    template="repro_torch.kernels.lstm_cell.ops",
    quantized="repro_torch.quant.qat.make_qat_lstm_apply",
    notes="the paper's own accelerator (Table I)"))
register(Component(
    "conv1d", ref="repro_torch.model.conv1d.conv1d_apply",
    template="repro_torch.rtl.oplib",
    notes="TCN-style depthwise sensor stack (rtl 'conv1d' hw template)"))
register(Component(
    "mlp", ref="repro_torch.model.layers.apply_mlp",
    quantized="repro_torch.kernels.quant_matmul.ops"))


def validate_config(cfg: ModelConfig) -> Dict[str, Component]:
    """Every block kind of this model must be a registered component."""
    from repro_torch.model.transformer import group_structure

    used = {}
    if cfg.family in ("lstm", "conv1d"):
        used[cfg.family] = get(cfg.family)
        return used
    for kind, _ in group_structure(cfg):
        used[kind] = get(kind)
    used["mlp"] = get("mlp")
    return used
