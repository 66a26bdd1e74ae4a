"""Architecture config registry (``get_config(<id>)``).

The port knows the paper's two designs so far; the LM zoo's configs come
with the slices that port those model families.
"""
from __future__ import annotations

import importlib

from repro_torch.core.types import ModelConfig

_ARCH_MODULES = {
    "elastic-lstm": "elastic_lstm",
    "elastic-conv1d": "elastic_conv1d",
}


def _mod(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; the PyTorch port knows only the "
            f"paper's designs {sorted(_ARCH_MODULES)} (the LM zoo is not "
            "ported yet)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of ``arch_id``."""
    return _mod(arch_id).config()
