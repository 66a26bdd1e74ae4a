"""The FPGA-friendly piecewise-linear activations (port of the
``hard_sigmoid``/``hard_tanh`` half of ``repro/quant/qat.py``).

They generate the activation ROM tables of the RTL templates. The
quantization-aware training loop waits for the training slice.
"""
from __future__ import annotations

import torch


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """PWL sigmoid: exact at 0/±2.5, slope 0.2 — one comparator + shift-add."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)
