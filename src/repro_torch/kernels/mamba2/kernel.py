"""Launcher of the CUDA SSD chunk-scan kernel (``csrc/ssd.cu``), the port of
``repro/kernels/mamba2/kernel.py::ssd_pallas``: three launches a call
(chunk states, the carry over the chunks, the output), with the scratch
they share allocated here."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: the largest head dim P and state size N the kernel is compiled for
MAX_DIM = 64
#: the three passes of a call, in launch order
PASSES = ("state", "carry", "output")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd")
    lib.ssd_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_launch.restype = ctypes.c_int
    lib.ssd_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ssd_plan.restype = ctypes.c_int
    return lib


def plan(Bsz: int, S: int, H: int, P: int, N: int) -> Dict[str, int]:
    """What a call launches, from the kernel itself: its chunk, the
    chunks, the blocks of each pass and the scratch's bytes."""
    out = (ctypes.c_longlong * 8)()
    _lib().ssd_plan(Bsz, S, H, P, N, out)
    return {"chunk": out[0], "chunks": out[1],
            **{f"blocks_{name}": out[2 + i] for i, name in enumerate(PASSES)},
            "scratch_bytes": 4 * (out[5] + out[6] + out[7])}


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor],
             y: torch.Tensor, h_final: torch.Tensor) -> None:
    """Launch on the current stream of ``x``'s device; checked operands
    (x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), h0 (B, H, P,
    N) or None, y like x, h_final (B, H, P, N); float32, contiguous, one
    device) come from the wrapper. The scratch, the chunk states of (B,
    nc, H, P, N), their decays and each chunk's C B^T, is allocated
    here."""
    lib = _lib()
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pl = plan(Bsz, S, H, P, N)
    nc, L = pl["chunks"], pl["chunk"]
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((Bsz, nc, H), dtype=torch.float32, device=x.device)
    cb = torch.empty((Bsz, nc, L, L), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(),
                         None if h0 is None else h0.data_ptr(),
                         y.data_ptr(), h_final.data_ptr(), states.data_ptr(),
                         decay.data_ptr(), cb.data_ptr(), Bsz, S, H, P, N,
                         stream)
    build.check(lib, err, "ssd launch")
