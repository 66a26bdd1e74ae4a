"""Plain PyTorch version of B3 (port of
``repro/kernels/lstm_cell/ref.py::lstm_window_ref``): the model-layer LSTM
step, ``model.lstm.lstm_cell_step``, over the window."""
from __future__ import annotations

import torch

from repro_torch.model.lstm import lstm_cell_step


def lstm_window_ref(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d_in) -> final hidden (B, hidden)."""
    B, S, _ = x.shape
    hidden = w.shape[1] // 4
    h = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
    for t in range(S):
        h, c = lstm_cell_step(w, b, x[:, t], h, c)
    return h
