"""The parameter-schema leaf (port of ``PSpec``/``is_pspec`` from
``repro/model/layers.py``).

A model's parameters are described once as nested dicts and lists of
:class:`PSpec` leaves. Sharding specs wait for the multi-GPU slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class PSpec:
    """One parameter leaf: shape + dtype + init, the single source of truth."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros
    scale: Optional[float] = None  # stddev override (default: 1/sqrt(fan_in))


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)
