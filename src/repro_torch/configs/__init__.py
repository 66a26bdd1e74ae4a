"""Architecture config registry (``get_config(<id>, smoke=False)``).

The port knows the paper's two designs and the dense LMs ``yi-9b`` and
``stablelm-3b``; the rest of the LM zoo comes with the slices that port
those model families. Each module exposes ``config()`` (the published
configuration) and ``smoke()`` (a reduced same-family variant for CPU
tests; the paper's designs are smoke-sized already).
"""
from __future__ import annotations

import importlib

from repro_torch.core.types import ModelConfig

_ARCH_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "yi-9b": "yi_9b",
    "elastic-lstm": "elastic_lstm",
    "elastic-conv1d": "elastic_conv1d",
}


def _mod(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; the PyTorch port knows "
            f"{sorted(_ARCH_MODULES)} (the rest of the LM zoo is not "
            "ported yet)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """The published configuration of ``arch_id``, or its smoke variant."""
    m = _mod(arch_id)
    return m.smoke() if smoke and hasattr(m, "smoke") else m.config()
