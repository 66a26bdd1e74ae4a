"""Public wrapper of the int8 matmul template (B4)."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import quant_matmul_cuda
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref, quantize_act

#: kernel launches made by :func:`quant_matmul` (CPU calls and
#: ``use_ref=True`` do not count)
launches = 0


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


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 *, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128, use_ref: bool = False) -> torch.Tensor:
    """float activations (M, K) × pre-quantized int8 weights (K, N) -> f32.

    The activations are quantized per tensor (:func:`quantize_act`, plain
    torch, as the reference does outside its kernel). On a CUDA tensor one
    kernel launch computes the int32 product and the rescale; on a CPU
    tensor, or with ``use_ref=True`` on either, the plain version does.
    ``block_m/n/k`` are the reference's TPU tiling; the CUDA kernel tiles
    128 × 128 × 64 and masks the ragged edges, which gives the same result
    for every tiling (the int32 sums are exact), so they are only checked.
    """
    global launches
    _check(x, wq, w_scale, (block_m, block_n, block_k))
    xq, xs = quantize_act(x)
    if use_ref or x.device.type == "cpu":
        return quant_matmul_ref(xq, wq, xs, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    M, N = xq.shape[0], wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        quant_matmul_cuda(xq.contiguous(), wq.contiguous(), xs.reshape(1),
                          w_scale.reshape(-1).contiguous(), out)
    launches += 1
    return out
