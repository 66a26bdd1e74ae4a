"""Launcher of the CUDA decode-attention kernels
(``csrc/decode_attention.cu``); replaces no TPU kernel."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

#: dtype codes of the C entry point; the dtype names the variant: "simt"
#: (f32, CUDA cores) or "mma" (bf16, ``mma.sync``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "simt", torch.bfloat16: "mma"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, out: torch.Tensor,
                          o_part: Optional[torch.Tensor],
                          ml_part: Optional[torch.Tensor], *, splits: int,
                          chunk: int) -> None:
    """Launch the kernel (and, for ``splits > 1``, its combine pass) on
    the current stream of ``q``'s device. Checked operands come from the
    wrapper: q and out (B, 1, H, hd), k and v (B, S, KV, hd), one dtype,
    head dim contiguous; kv_len (B,) int32; o_part (B * KV, splits, G, hd)
    and ml_part (B * KV, splits, G, 2) f32 scratch where ``splits > 1``."""
    lib = _lib()
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), o_part.data_ptr() if o_part is not None else None,
        ml_part.data_ptr() if ml_part is not None else None, B, KV, H // KV,
        S, hd, splits, chunk, q.stride(0), q.stride(2), *k.stride()[:3],
        *v.stride()[:3], out.stride(0), out.stride(2), hd ** -0.5,
        DTYPES[q.dtype], stream)
    build.check(lib, err, f"decode_attention {VARIANTS[q.dtype]} launch")
