"""Architecture config registry (``get_config(<id>, smoke=False)``).

The port knows the paper's two designs and the reference's whole LM zoo:
dense (``yi-9b``, ``stablelm-3b``, ``stablelm-12b``, ``qwen3-32b``), MoE
(``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``), VLM (``internvl2-1b``),
audio (``whisper-tiny``), hybrid (``zamba2-7b``) and RWKV (``rwkv6-7b``).
Each module exposes ``config()`` (the published configuration) and
``smoke()`` (a reduced same-family variant for CPU tests; the paper's
designs are smoke-sized already).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.core.types import ModelConfig

_ARCH_MODULES = {
    "stablelm-12b": "stablelm_12b",
    "stablelm-3b": "stablelm_3b",
    "yi-9b": "yi_9b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-1b": "internvl2_1b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "elastic-lstm": "elastic_lstm",
    "elastic-conv1d": "elastic_conv1d",
}

_PAPER_IDS = ("elastic-lstm", "elastic-conv1d")
ARCH_IDS = tuple(k for k in _ARCH_MODULES if k not in _PAPER_IDS)
ALL_IDS = tuple(_ARCH_MODULES)


def _mod(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``arch_id``, or its smoke variant."""
    m = _mod(arch_id)
    return m.smoke() if smoke else m.config()


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke=smoke) for a in ALL_IDS}
