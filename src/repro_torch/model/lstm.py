"""The paper's own accelerator workload: LSTM time-series predictor.

Port of ``repro/model/lstm.py`` (ref [11], Table I: ``hidden=20`` cell,
window of 6 lags, one dense output). The cell is gate-fused: one
(in+hidden) × 4·hidden matrix, gate order i, f, g, o.
:func:`lstm_cell_step` is one float step of that cell (also the oracle of
the float LSTM-window kernel); :func:`lstm_apply` is the stacked float
forward that Stage 1 trains.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
            "w": PSpec((d_in + c.hidden, 4 * c.hidden), dtype=torch.float32),
            "b": PSpec((4 * c.hidden,), dtype=torch.float32, init="zeros"),
        })
    return {
        "cells": layers,
        "head_w": PSpec((c.hidden, c.out_features), dtype=torch.float32),
        "head_b": PSpec((c.out_features,), dtype=torch.float32,
                          init="zeros"),
    }


def lstm_cell_step(w: torch.Tensor, b: torch.Tensor, x_t: torch.Tensor,
                   h: torch.Tensor, c: torch.Tensor):
    """x_t: (B, D_in); h/c: (B, hidden). Returns (h', c')."""
    z = torch.cat([x_t, h], dim=-1) @ w + b                 # (B, 4*hidden)
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_apply(p, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
    """Runs the stacked LSTM over the window ``x`` (B, S, in_features) f32;
    returns (pred (B, out), ((h, c) per layer))."""
    c = cfg.lstm
    B, S, _ = x.shape
    h_states = []
    seq = x
    for li, cell in enumerate(p["cells"]):
        h = seq.new_zeros((B, c.hidden)) if state is None else state[li][0]
        cc = seq.new_zeros((B, c.hidden)) if state is None else state[li][1]
        outs = []
        for t in range(S):  # unrolled: window is 6 — exact cost accounting
            h, cc = lstm_cell_step(cell["w"], cell["b"], seq[:, t], h, cc)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        h_states.append((h, cc))
    pred = seq[:, -1] @ p["head_w"] + p["head_b"]
    return pred, tuple(h_states)


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
