"""The paper's own accelerator workload: LSTM time-series predictor.

Port of the schema half of ``repro/model/lstm.py`` (ref [11], Table I:
``hidden=20`` cell, window of 6 lags, one dense output). The cell is
gate-fused: one (in+hidden) × 4·hidden matrix, gate order i, f, g, o. The
float forward waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import PSpec


def lstm_schema(cfg: ModelConfig):
    c = cfg.lstm
    layers = []
    for i in range(c.n_layers):
        d_in = c.in_features if i == 0 else c.hidden
        layers.append({
            # gate order: i, f, g, o (fused)
            "w": PSpec((d_in + c.hidden, 4 * c.hidden), torch.float32),
            "b": PSpec((4 * c.hidden,), torch.float32, init="zeros"),
        })
    return {
        "cells": layers,
        "head_w": PSpec((c.hidden, c.out_features), torch.float32),
        "head_b": PSpec((c.out_features,), torch.float32, init="zeros"),
    }


def lstm_flops(cfg: ModelConfig) -> int:
    """MAC-counted ops per single inference (the paper counts OP = MAC*2)."""
    c = cfg.lstm
    total = 0
    for i in range(c.n_layers):
        d_in = c.in_features if i == 0 else c.hidden
        per_step = 2 * (d_in + c.hidden) * 4 * c.hidden + 4 * c.hidden
        total += per_step * c.seq_len
    total += 2 * c.hidden * c.out_features
    return total
