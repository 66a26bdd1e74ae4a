"""Public wrapper of the fused integer LSTM-window template (B1)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lstm_cell_int.kernel import (CellSpec,
                                                      lstm_window_int_cuda)
from repro_torch.kernels.lstm_cell_int.ref import lstm_window_int_ref

#: kernel launches made by :func:`lstm_window_int` (CPU calls do not count)
launches = 0


def _check(x, w, b, sig_table, tanh_table, spec: CellSpec) -> None:
    H, d_in = spec.hidden, spec.d_in
    operands = {"x": (x, (*x.shape[:1], spec.seq_len, d_in)),
                "w": (w, (d_in + H, 4 * H)), "b": (b, (4 * H,)),
                "sig_table": (sig_table, tuple(sig_table.shape[:1])),
                "tanh_table": (tanh_table, tuple(tanh_table.shape[:1]))}
    for name, (t, want) in operands.items():
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(
                f"lstm_window_int: {name} must be int32 of shape {want}, "
                f"got {t.dtype} {tuple(t.shape)} (spec {spec})")
        if not t.is_contiguous():
            raise ValueError(f"lstm_window_int: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"lstm_window_int: {name} is on {t.device}, "
                             f"x on {x.device}")
    A, C, W = spec.act_fmt, spec.state_fmt, spec.w_fmt
    # every ROM address is an act_fmt code (gates and requant(c) are
    # saturated to A), so both tables must cover [A.lo, A.hi]
    for name, lo, depth in (("sig", spec.sig_lo, sig_table.shape[0]),
                            ("tanh", spec.tanh_lo, tanh_table.shape[0])):
        if lo > A.lo or A.hi - lo >= depth:
            raise ValueError(
                f"lstm_window_int: {name} ROM (offset {lo}, depth {depth}) "
                f"does not cover the {A} code range")
    if not 0 <= C.frac_bits - A.frac_bits < 32 or \
            not 0 <= W.frac_bits < 32 or not 0 <= A.frac_bits < 32:
        raise ValueError(f"lstm_window_int: formats A={A} W={W} C={C} need "
                         "shifts in [0, 32) and state precision >= act")


def lstm_window_int(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    sig_table: torch.Tensor, tanh_table: torch.Tensor,
                    *, spec: CellSpec) -> torch.Tensor:
    """(B,S,d_in) int codes × fused int gate weights -> (B, S, hidden) int32.

    One kernel launch per window batch on a CUDA tensor; the plain version
    on a CPU tensor.
    """
    global launches
    _check(x, w, b, sig_table, tanh_table, spec)
    if x.device.type == "cpu":
        return lstm_window_int_ref(x, w, b, sig_table, tanh_table, spec=spec)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_window_int: no kernel for device {x.device}")
    out = torch.empty((x.shape[0], spec.seq_len, spec.hidden),
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        lstm_window_int_cuda(x, w, b, sig_table, tanh_table, out, spec=spec)
    launches += 1
    return out
