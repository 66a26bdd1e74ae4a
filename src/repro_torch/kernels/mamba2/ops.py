"""Public wrapper of the SSD chunk-scan template (B6): the (B, S, H, P)
layout, the n_groups = 1 broadcast and the optional initial state."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.mamba2.kernel import MAX_DIM, ssd_cuda
from repro_torch.kernels.mamba2.ref import ssd_reference

#: kernel launches made by :func:`ssd` (CPU calls do not count)
launches = 0


def _check(x, dt, A, Bm, Cm, h0, chunk: int) -> None:
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"ssd: x must be (B, S, H, P) and B/C (B, S, G, N),"
                         f" got {tuple(x.shape)}, {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G != 1:
        raise ValueError(f"ssd: the template is instantiated for n_groups=1 "
                         f"(zamba2), got G={G}")
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bsz, S, 1, N)), "Cm": (Cm, (Bsz, S, 1, N))}
    if h0 is not None:
        want["h0"] = (h0, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssd: {name} is on {t.device}, x on "
                             f"{x.device}")
    if S < 1 or chunk < 1:
        raise ValueError(f"ssd: needs S >= 1 and chunk >= 1, got S={S}, "
                         f"chunk={chunk}")
    if S % min(chunk, S):
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk "
                         f"{min(chunk, S)}")


@reports("ssd", lambda x, dt, A, Bm, *_, **__: 4 * x.numel()
         * Bm.shape[-1])
def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
        *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B/C: (B,S,G,N), n_groups G=1.

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32), from the
    state ``h0`` (zero without one). ``min(chunk, S)`` must divide S, as the
    reference's wrapper asks; the result does not depend on it. On a CUDA
    tensor one call launches the kernel's three passes (chunk states, the
    carry over the chunks from ``h0``, the output) in chunks of its own; on
    a CPU tensor the per-step plain version runs; on a ``meta`` tensor the
    empty results come back.

    Its work: each step and head reads the (P, N) state into y and folds
    x and B into it, 4 · P · N FLOPs a (batch, step, head).
    """
    global launches
    _check(x, dt, A, Bm, Cm, h0, chunk)
    dtf, Af = dt.float(), A.float()
    if x.device.type == "cpu":
        return ssd_reference(x, dtf, Af, Bm, Cm,
                             h0=None if h0 is None else h0.float())
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.device.type == "meta":
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device))
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd: the CUDA kernel takes P, N <= {MAX_DIM}, "
                         f"got P={P}, N={N}")
    yf = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    hf = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        ssd_cuda(x.float().contiguous(), dtf.contiguous(), Af.contiguous(),
                 Bm[:, :, 0].float().contiguous(),
                 Cm[:, :, 0].float().contiguous(),
                 None if h0 is None else h0.float().contiguous(), yf, hf)
    launches += 1
    return yf.to(x.dtype), hf
