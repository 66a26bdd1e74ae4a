"""Launcher of the CUDA float LSTM-window kernels (``csrc/lstm_cell.cu``),
the port of ``repro/kernels/lstm_cell/kernel.py::lstm_window_pallas``.

One launch runs every timestep of the cell for a whole batch of windows and
writes only the final hidden state. Two variants:

* ``mma`` — the gate product on the tensor cores in split TF32
  (``mma.sync`` m16n8k8, three products a term: f32 accuracy), 16 windows
  a warp tile, c in registers, h fed back through a per-warp A tile, each
  activation one MUFU exponential and one MUFU reciprocal (within 2.4e-7
  of the accurate forms, :func:`activation_sweep`); for cells with hidden
  <= :data:`MMA_MAX_HIDDEN` and K = d_in + hidden <= :data:`MMA_MAX_K`
  (:func:`mma_takes`);
* ``simt`` — f32 FMAs on the CUDA cores and the accurate ``expf``, IEEE
  reciprocal and ``tanhf``, (window, unit) pairs a thread, any shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: the kernels of ``csrc/lstm_cell.cu``, by the number its C entry point
#: takes
VARIANTS = {"simt": 0, "mma": 1}
#: the ``mma`` kernel's instances: 4 * hidden gate columns in at most 32 n8
#: tiles, K = d_in + hidden in at most 16 k8 steps (the largest instance
#: then keeps W as f32 fragments in 131 KB of shared memory)
MMA_MAX_HIDDEN = 64
MMA_MAX_K = 128


def mma_takes(d_in: int, hidden: int) -> bool:
    """Whether the ``mma`` kernel has an instance for this cell."""
    return hidden <= MMA_MAX_HIDDEN and d_in + hidden <= MMA_MAX_K


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell")
    lib.lstm_cell_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.lstm_cell_launch.restype = ctypes.c_int
    lib.lstm_cell_act_sweep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_void_p]
    lib.lstm_cell_act_sweep.restype = ctypes.c_int
    return lib


def activation_sweep(z: torch.Tensor) -> torch.Tensor:
    """Both kernels' activations at each z of a float32 CUDA tensor: (n, 4)
    of the ``mma`` kernel's MUFU sigmoid, ``simt``'s accurate sigmoid, the
    MUFU tanh and the accurate tanh, computed on the card by the functions
    the kernels inline."""
    z = z.reshape(-1).contiguous()
    out = torch.empty((z.numel(), 4), dtype=torch.float32, device=z.device)
    lib = _lib()
    err = lib.lstm_cell_act_sweep(
        z.data_ptr(), out.data_ptr(), z.numel(),
        torch.cuda.current_stream(z.device).cuda_stream)
    build.check(lib, err, "lstm_cell_act_sweep launch")
    return out


def lstm_window_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     out: torch.Tensor, *, block_b: int,
                     variant: str) -> None:
    """Launch the named variant on the current stream of ``x``'s device;
    checked operands (float32, contiguous, one device) come from the
    wrapper.

    ``simt`` takes any cell, ``block_b`` windows to a block. ``mma`` takes
    only a cell :func:`mma_takes` and does not read ``block_b``: its blocks
    are 4 warps of 16-window tiles, two tiles a warp at Table I.
    """
    if variant not in VARIANTS:
        raise ValueError(f"lstm_window_cuda: unknown variant {variant!r}; "
                         f"one of {sorted(VARIANTS)}")
    B, S, d_in = x.shape
    H = w.shape[1] // 4
    if variant == "mma" and not mma_takes(d_in, H):
        raise ValueError(f"lstm_window_cuda: the mma kernel does not take "
                         f"d_in={d_in}, hidden={H}: it needs hidden <= "
                         f"{MMA_MAX_HIDDEN} and d_in + hidden <= {MMA_MAX_K}")
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               out.data_ptr(), B, S, d_in, H, block_b,
                               VARIANTS[variant], stream)
    build.check(lib, err, f"lstm_cell {variant} launch")
