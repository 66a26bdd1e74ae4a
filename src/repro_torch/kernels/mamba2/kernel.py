"""Launcher of the CUDA SSD chunk-scan kernel (``csrc/ssd.cu``), the port of
``repro/kernels/mamba2/kernel.py::ssd_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: the largest head dim P and state size N the kernel is compiled for
MAX_DIM = 64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd")
    lib.ssd_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssd_launch.restype = ctypes.c_int
    return lib


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
             h_final: torch.Tensor, *, chunk: int) -> None:
    """Launch on the current stream of ``x``'s device; checked operands
    (x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), y like x,
    h_final (B, H, P, N); float32, contiguous, one device) come from the
    wrapper, with ``S % chunk == 0``."""
    lib = _lib()
    Bsz, S, H, P = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                         h_final.data_ptr(), Bsz, S, H, P, Bm.shape[-1],
                         chunk, stream)
    build.check(lib, err, "ssd launch")
