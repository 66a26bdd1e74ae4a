"""Launcher of the CUDA WKV6 kernel (``csrc/wkv6.cu``), the port of
``repro/kernels/rwkv6/kernel.py::wkv6_pallas``: three launches a call
(chunk states, the carry over the chunks, the output), with the scratch
they share allocated here."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: steps per subchunk (``repro/kernels/rwkv6/kernel.py:18``)
SUB = 16
#: the largest head size N the kernel is compiled for
MAX_DIM = 64
#: the three passes of a call, in launch order
PASSES = ("state", "carry", "output")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    lib.wkv6_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv6_plan.restype = ctypes.c_int
    return lib


def plan(Bsz: int, S: int, H: int, N: int) -> Dict[str, int]:
    """What a call launches, from the kernel itself: its chunk, the
    chunks, the blocks of each pass and the scratch's bytes."""
    out = (ctypes.c_longlong * 7)()
    _lib().wkv6_plan(Bsz, S, H, N, out)
    return {"chunk": out[0], "chunks": out[1],
            **{f"blocks_{name}": out[2 + i] for i, name in enumerate(PASSES)},
            "scratch_bytes": 4 * (out[5] + out[6])}


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w_log: torch.Tensor, u: torch.Tensor,
              h0: Optional[torch.Tensor], y: torch.Tensor,
              h_final: torch.Tensor) -> None:
    """Launch on the current stream of ``r``'s device; checked operands
    (r, k, v, w_log, y (B, S, H, N), u (H, N), h0 (B, H, N, N) or None,
    h_final (B, H, N, N); float32, contiguous, one device) come from the
    wrapper. The scratch, the chunk states of (B, nc, H, N, N) and their
    per-row decays, is allocated here."""
    lib = _lib()
    Bsz, S, H, N = r.shape
    nc = plan(Bsz, S, H, N)["chunks"]
    states = torch.empty((Bsz, nc, H, N, N), dtype=torch.float32,
                         device=r.device)
    decay = torch.empty((Bsz, nc, H, N), dtype=torch.float32,
                        device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w_log.data_ptr(), u.data_ptr(),
                          None if h0 is None else h0.data_ptr(),
                          y.data_ptr(), h_final.data_ptr(),
                          states.data_ptr(), decay.data_ptr(), Bsz, S, H, N,
                          stream)
    build.check(lib, err, "wkv6 launch")
