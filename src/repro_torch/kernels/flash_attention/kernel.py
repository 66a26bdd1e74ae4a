"""Launcher of the CUDA flash-attention kernels (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: variant codes of the C entry point: "sm90" (wgmma + TMA, bf16, hd <= 128)
#: and "simt" (CUDA cores, every dtype and hd <= 256)
VARIANTS = {"simt": 0, "sm90": 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool,
                         variant: str) -> None:
    """Launch ``variant`` on the current stream of ``q``'s device; checked
    operands ((B, S, H, hd), one dtype, head dim contiguous, and what the
    variant needs) come from the wrapper."""
    lib = _lib()
    B, Sq, H, hd = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq,
        k.shape[1], hd, *strides, hd ** -0.5, int(causal), DTYPES[q.dtype],
        VARIANTS[variant], stream)
    build.check(lib, err, f"flash_attention {variant} launch")
