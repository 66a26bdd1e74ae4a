"""Launcher of the CUDA int8 matmul kernels (``csrc/quant_matmul.cu``), the
port of ``repro/kernels/quant_matmul/kernel.py::quant_matmul_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: variant codes of the C entry point: "sm90" (wgmma fed by TMA) and
#: "gemv" (weights streamed once with dp4a), both on K-major codes
VARIANTS = {"sm90": 1, "gemv": 2}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("quant_matmul")
    lib.quant_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p])
    lib.quant_matmul_launch.restype = ctypes.c_int
    return lib


def rows_readable(t: torch.Tensor) -> bool:
    """Whether TMA and 16-byte vector loads can read the rows of ``t``
    (R, K): each row's codes contiguous, rows a multiple of 16 bytes
    apart, the base 16-byte aligned. A one-row view counts its pitch as
    K."""
    R, K = t.shape
    pitch = t.stride(0) if R > 1 else K
    return (t.stride(1) == 1 and pitch >= K and pitch % 16 == 0
            and t.data_ptr() % 16 == 0)


def tma_readable(xq: torch.Tensor, wq: torch.Tensor) -> bool:
    """Whether the kernels can read these codes: xq (M, K) row-major, wq
    (K, N) K-major (strides ``(1, pitch)``, each output channel's codes
    contiguous), K a positive multiple of 16, the rows of both as
    :func:`rows_readable` needs them (TMA's rules)."""
    K = xq.shape[1]
    return (K > 0 and K % 16 == 0 and xq.is_contiguous()
            and rows_readable(xq) and rows_readable(wq.T))


def quant_matmul_cuda(xq: torch.Tensor, wq: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      out: torch.Tensor, *, variant: str) -> None:
    """Launch ``variant`` on the current stream of ``xq``'s device.

    Checked operands come from the wrapper: xq (M, K) int8, x_scale (1,)
    and w_scale (N,) float32, out (M, N) float32 contiguous, one device.
    Both variants read what :func:`tma_readable` accepts, at any M; other
    layouts raise (the wrapper copies them first, ``ops.tma_codes``).
    """
    if variant not in VARIANTS:
        raise ValueError(f"quant_matmul: no variant {variant!r}, only "
                         f"{sorted(VARIANTS)}")
    M, K = xq.shape
    N = wq.shape[1]
    if not tma_readable(xq, wq):
        raise ValueError(f"quant_matmul {variant}: cannot read xq strides "
                         f"{xq.stride()} with wq strides {wq.stride()} at K "
                         f"= {K}")
    lib = _lib()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.quant_matmul_launch(xq.data_ptr(), wq.data_ptr(),
                                  x_scale.data_ptr(), w_scale.data_ptr(),
                                  out.data_ptr(), M, N, K,
                                  K if N == 1 else wq.stride(1),
                                  VARIANTS[variant], stream)
    build.check(lib, err, f"quant_matmul {variant} launch")
