"""TCN-style depthwise conv1d stack — the sensor workload beyond the LSTM.

Port of the schema and framing half of ``repro/model/conv1d.py``. The float
forward waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import PSpec


def conv1d_schema(cfg: ModelConfig):
    c = cfg.conv1d
    blocks = [{
        "w": PSpec((c.kernel, c.channels), torch.float32),
        "b": PSpec((c.channels,), torch.float32, init="zeros"),
    } for _ in range(c.n_blocks)]
    return {
        "blocks": blocks,
        "head_w": PSpec((c.flat_features, c.out_features), torch.float32),
        "head_b": PSpec((c.out_features,), torch.float32, init="zeros"),
    }


def conv1d_frames(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, S, C) -> (B, T, K, C) strided tap windows, T=(S-K)//stride+1.

    THE framing of the conv1d vertical: the RTL template's emulator and
    float oracle (``repro_torch.rtl.oplib.Conv1dTemplate``) both go through
    this helper.
    """
    return x.unfold(1, kernel, stride).transpose(2, 3)
