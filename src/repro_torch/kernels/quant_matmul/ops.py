"""Public wrapper of the int8 matmul template (B4)."""
from __future__ import annotations

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.quant_matmul.kernel import (quant_matmul_cuda,
                                                     rows_readable,
                                                     tma_readable)
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref, quantize_act

#: kernel launches made by :func:`quant_matmul` (CPU calls and
#: ``use_ref=True`` do not count)
launches = 0
#: ... and by the variant :func:`variant` chose
launches_by_variant = {"sm90": 0, "gemv": 0}

#: the most rows the ``gemv`` variant takes through the wrapper: a decode
#: tick of up to 16 slots. Below it a 128-row wgmma tile would be mostly
#: padding, and ``torch._int_mm`` itself needs more than 16 rows.
GEMV_MAX_ROWS = 16


def variant(xq: torch.Tensor, wq: torch.Tensor) -> str:
    """The kernel a CUDA call with these codes launches, decided from the
    rows alone: ``"gemv"`` (weights streamed once) for M <=
    :data:`GEMV_MAX_ROWS`, ``"sm90"`` (wgmma fed by TMA) for the rest.
    Both read the codes :func:`tma_codes` hands them."""
    return "gemv" if xq.shape[0] <= GEMV_MAX_ROWS else "sm90"


def tma_codes(xq: torch.Tensor, wq: torch.Tensor):
    """``(xq, wq)`` as both kernels read them
    (:func:`~repro_torch.kernels.quant_matmul.kernel.tma_readable`):
    row-major activation codes, K-major weight codes (strides
    ``(1, pitch)``, as ``quant/ptq.py`` and ``convert.py`` store them), K
    and the pitch multiples of 16, 16-byte-aligned bases.

    Codes that already are so are returned as they are. Any other layout
    (row-major weights, K % 16 != 0, an unaligned view) gets a one-off
    copy, with K zero-padded to a multiple of 16 on both sides where it is
    not one; zero codes leave the int32 sums, and so the result, exactly as
    they were. A model's weights never take the copy.
    """
    if tma_readable(xq, wq):
        return xq, wq
    M, K = xq.shape
    N = wq.shape[1]
    kp = max(16, -(-K // 16) * 16)
    if kp != K or not (xq.is_contiguous() and rows_readable(xq)):
        padded = xq.new_zeros(M, kp)
        padded[:, :K] = xq
        xq = padded
    if kp != K or not rows_readable(wq.T):
        padded = wq.new_zeros(N, kp)
        padded[:, :K] = wq.T
        wq = padded.T
    return xq, wq


def _check(x, wq, w_scale, blocks) -> None:
    if x.ndim != 2 or not x.is_floating_point():
        raise ValueError(f"quant_matmul: x must be float (M, K), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != x.shape[1]:
        raise ValueError(f"quant_matmul: wq must be int8 (K, N) with K = "
                         f"{x.shape[1]}, got {wq.dtype} {tuple(wq.shape)}")
    if w_scale.dtype != torch.float32 or w_scale.numel() != wq.shape[1]:
        raise ValueError(f"quant_matmul: w_scale must be float32 with N = "
                         f"{wq.shape[1]} entries, got {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    for name, t in (("wq", wq), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
    if min(blocks) < 1:
        raise ValueError(f"quant_matmul: block sizes must be >= 1, got "
                         f"{blocks}")


@reports("quant_matmul", lambda x, wq, *_, **__: 2 * x.shape[0]
         * x.shape[1] * wq.shape[1])
def quant_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 *, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128, use_ref: bool = False) -> torch.Tensor:
    """float activations (M, K) × pre-quantized int8 weights (K, N) -> f32.

    The activations are quantized per tensor (:func:`quantize_act`, plain
    torch, as the reference does outside its kernel). On a CUDA tensor one
    kernel launch computes the int32 product and the rescale; on a CPU
    tensor, or with ``use_ref=True`` on either, the plain version does; on
    a ``meta`` tensor the empty result comes back.
    The kernel is the one :func:`variant` names. ``block_m/n/k`` are the
    reference's TPU tiling; the CUDA kernels tile as they need and read
    zeros past the ragged edges, which gives the same result for every
    tiling (the int32 sums are exact), so they are only checked.
    """
    global launches
    _check(x, wq, w_scale, (block_m, block_n, block_k))
    xq, xs = quantize_act(x)
    if use_ref or x.device.type == "cpu":
        return quant_matmul_ref(xq, wq, xs, w_scale)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], wq.shape[1]), dtype=torch.float32,
                           device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    M, N = xq.shape[0], wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    xq, wq = tma_codes(xq, wq)
    name = variant(xq, wq)
    with torch.cuda.device(x.device):
        quant_matmul_cuda(xq, wq, xs.reshape(1),
                          w_scale.reshape(-1).contiguous(), out,
                          variant=name)
    launches += 1
    launches_by_variant[name] += 1
    return out
