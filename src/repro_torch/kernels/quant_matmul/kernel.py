"""Launcher of the CUDA int8 matmul kernel (``csrc/quant_matmul.cu``), the
port of ``repro/kernels/quant_matmul/kernel.py::quant_matmul_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("quant_matmul")
    lib.quant_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.quant_matmul_launch.restype = ctypes.c_int
    return lib


def quant_matmul_cuda(xq: torch.Tensor, wq: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch on the current stream of ``xq``'s device; checked operands
    (xq (M, K) / wq (K, N) int8, x_scale (1,) and w_scale (N,) float32, out
    (M, N) float32, contiguous, one device) come from the wrapper."""
    lib = _lib()
    M, K = xq.shape
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.quant_matmul_launch(xq.data_ptr(), wq.data_ptr(),
                                  x_scale.data_ptr(), w_scale.data_ptr(),
                                  out.data_ptr(), M, wq.shape[1], K, stream)
    build.check(lib, err, "quant_matmul launch")
