"""Public wrapper of the WKV6 template (B7): the (B, S, H, N) layout and
the optional initial state."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.rwkv6.kernel import MAX_DIM, SUB, wkv6_cuda
from repro_torch.kernels.rwkv6.ref import wkv6_reference

#: kernel launches made by :func:`wkv6` (CPU calls do not count)
launches = 0


def _check(r, k, v, w_log, u, h0, chunk: int) -> None:
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, N), got "
                         f"{tuple(r.shape)}")
    B, S, H, N = r.shape
    want = {"k": (k, r.shape), "v": (v, r.shape), "w_log": (w_log, r.shape),
            "u": (u, (H, N))}
    if h0 is not None:
        want["h0"] = (h0, (B, H, N, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on "
                             f"{r.device}")
    if S < 1 or chunk < 1:
        raise ValueError(f"wkv6: needs S >= 1 and chunk >= 1, got S={S}, "
                         f"chunk={chunk}")
    L = min(chunk, S)
    if S % L or L % SUB:
        raise ValueError(f"wkv6: S={S} must be a multiple of the chunk {L}, "
                         f"and the chunk a multiple of {SUB}")


@reports("wkv6", lambda r, *_, **__: 4 * r.numel() * r.shape[-1])
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor,
         h0: Optional[torch.Tensor] = None, *, chunk: int = 128
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w_log: (B,S,H,N), w_log <= 0; u: (H,N). Returns (y (B,S,H,N)
    in r's dtype, final_state (B,H,N,N) f32), from the state ``h0`` (zero
    without one).

    ``min(chunk, S)`` must divide S and be a multiple of 16, as the
    reference's wrapper asks; the result does not depend on it. On a CUDA
    tensor one call launches the kernel's three passes (chunk states, the
    carry over the chunks from ``h0``, the output) in chunks of its own; on
    a CPU tensor the per-step plain version runs; on a ``meta`` tensor the
    empty results come back.

    Its work: each step and head reads the (N, N) state into y and folds
    k and v into it, 4 · N · N FLOPs a (batch, step, head).
    """
    global launches
    _check(r, k, v, w_log, u, h0, chunk)
    wf = w_log.float()
    h0f = None if h0 is None else h0.float()
    if r.device.type == "cpu":
        return wkv6_reference(r, k, v, wf, u, h0=h0f)
    B, S, H, N = r.shape
    if r.device.type == "meta":
        return (torch.empty(r.shape, dtype=r.dtype, device=r.device),
                torch.empty((B, H, N, N), dtype=torch.float32,
                            device=r.device))
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    if N > MAX_DIM:
        raise ValueError(f"wkv6: the CUDA kernel takes N <= {MAX_DIM}, "
                         f"got N={N}")
    yf = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    hf = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        wkv6_cuda(*(t.float().contiguous() for t in (r, k, v, wf, u)),
                  None if h0f is None else h0f.contiguous(), yf, hf)
    launches += 1
    return yf.to(r.dtype), hf
