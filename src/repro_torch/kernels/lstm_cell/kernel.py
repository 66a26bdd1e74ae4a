"""Launcher of the CUDA float LSTM-window kernel (``csrc/lstm_cell.cu``),
the port of ``repro/kernels/lstm_cell/kernel.py::lstm_window_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell")
    lib.lstm_cell_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.lstm_cell_launch.restype = ctypes.c_int
    return lib


def lstm_window_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     out: torch.Tensor, *, block_b: int) -> None:
    """Launch on the current stream of ``x``'s device; checked operands
    (float32, contiguous, one device) come from the wrapper."""
    lib = _lib()
    B, S, d_in = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               out.data_ptr(), B, S, d_in, w.shape[1] // 4,
                               block_b, stream)
    build.check(lib, err, "lstm_cell launch")
