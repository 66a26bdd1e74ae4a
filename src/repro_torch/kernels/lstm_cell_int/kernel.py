"""Launcher of the CUDA fused integer LSTM-window kernel
(``csrc/lstm_cell_int.cu``), the port of
``repro/kernels/lstm_cell_int/kernel.py::lstm_window_int_pallas``.

One launch runs every timestep of one ``lstm_cell`` node for a whole batch
of windows: the gate matrix, the bias and both activation ROMs are staged in
shared memory per block, the int32 (h, c) state stays on chip, and only the
(B, S, hidden) hidden sequence is written out.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.quant.fixedpoint import FxpFormat


@dataclass(frozen=True)
class CellSpec:
    """Static metadata of one lstm_cell node: the window geometry, the
    three Q-formats' requant parameters, and the LUT address offsets (ROM
    tables are indexed by ``code - lo``, offset-binary order)."""

    seq_len: int
    d_in: int
    hidden: int
    act_fmt: FxpFormat               # A: x, h, gate post-LUT values
    state_fmt: FxpFormat             # C: cell state
    w_fmt: FxpFormat                 # W: gate matrix codes
    sig_lo: int                      # sigmoid ROM address offset
    tanh_lo: int                     # tanh ROM address offset


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell_int")
    lib.lstm_cell_int_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 14
        + [ctypes.c_void_p])
    lib.lstm_cell_int_launch.restype = ctypes.c_int
    return lib


def lstm_window_int_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         sig_table: torch.Tensor, tanh_table: torch.Tensor,
                         out: torch.Tensor, *, spec: CellSpec) -> None:
    """Launch on the current stream of ``x``'s device; checked operands
    (int32, contiguous, one device) come from the wrapper."""
    lib = _lib()
    A, C = spec.act_fmt, spec.state_fmt
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_int_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), sig_table.data_ptr(),
        tanh_table.data_ptr(), out.data_ptr(), x.shape[0], spec.seq_len,
        spec.d_in, spec.hidden, spec.w_fmt.frac_bits, A.frac_bits,
        C.frac_bits, A.lo, A.hi, C.lo, C.hi, spec.sig_lo, spec.tanh_lo,
        sig_table.shape[0], tanh_table.shape[0], stream)
    build.check(lib, err, "lstm_cell_int launch")
