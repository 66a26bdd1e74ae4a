"""Launcher of the CUDA integer MAC kernel (``csrc/mac_int.cu``), the port
of ``repro/rtl/oplib.py::mac_int_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("mac_int")
    lib.mac_int_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.mac_int_launch.restype = ctypes.c_int
    return lib


def mac_int_cuda(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor, *, shift: int, lo: int, hi: int) -> None:
    """Launch on the current stream of ``xh``'s device; checked operands
    (int32, contiguous, one device) come from the wrapper."""
    lib = _lib()
    rows, k = xh.shape
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = lib.mac_int_launch(xh.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), rows, k, w.shape[1], shift, lo,
                             hi, stream)
    build.check(lib, err, "mac_int launch")
