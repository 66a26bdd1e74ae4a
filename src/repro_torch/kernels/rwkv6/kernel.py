"""Launcher of the CUDA WKV6 kernel (``csrc/wkv6.cu``), the port of
``repro/kernels/rwkv6/kernel.py::wkv6_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: steps per subchunk (``repro/kernels/rwkv6/kernel.py:18``)
SUB = 16
#: the largest head size N the kernel is compiled for
MAX_DIM = 64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    lib.wkv6_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.wkv6_launch.restype = ctypes.c_int
    return lib


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w_log: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
              h_final: torch.Tensor) -> None:
    """Launch on the current stream of ``r``'s device; checked operands
    (r, k, v, w_log, y (B, S, H, N), u (H, N), h_final (B, H, N, N);
    float32, contiguous, one device; S % 16 == 0) come from the wrapper."""
    lib = _lib()
    Bsz, S, H, N = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w_log.data_ptr(), u.data_ptr(), y.data_ptr(),
                          h_final.data_ptr(), Bsz, S, H, N, stream)
    build.check(lib, err, "wkv6 launch")
