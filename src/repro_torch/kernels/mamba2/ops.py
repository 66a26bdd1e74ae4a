"""Public wrapper of the SSD chunk-scan template (B6): the (B, S, H, P)
layout, the n_groups = 1 broadcast and the optional h0 fold-in."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mamba2.kernel import MAX_DIM, ssd_cuda
from repro_torch.kernels.mamba2.ref import ssd_reference

#: kernel launches made by :func:`ssd` (CPU calls do not count)
launches = 0


def _check(x, dt, A, Bm, Cm, h0, chunk: int) -> int:
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
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk {L}")
    return L


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
        *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B/C: (B,S,G,N), n_groups G=1.

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32). The scan
    starts from a zero state; a nonzero ``h0`` is folded in afterwards (the
    recurrence is linear in the state): y += (C e^{a_cs}) h0ᵀ and
    S += e^{a_tot} h0, as the reference wrapper does. On a CUDA tensor one
    kernel launch scans every (batch, head) in chunks of ``min(chunk, S)``
    (which must divide S); on a CPU tensor the per-step plain version runs.
    """
    global launches
    L = _check(x, dt, A, Bm, Cm, h0, chunk)
    dtf, Af = dt.float(), A.float()
    if x.device.type == "cpu":
        y, hf = ssd_reference(x, dtf, Af, Bm, Cm)
    elif x.device.type == "cuda":
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        if P > MAX_DIM or N > MAX_DIM:
            raise ValueError(f"ssd: the CUDA kernel takes P, N <= {MAX_DIM},"
                             f" got P={P}, N={N}")
        yf = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
        hf = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            ssd_cuda(x.float().contiguous(), dtf.contiguous(),
                     Af.contiguous(), Bm[:, :, 0].float().contiguous(),
                     Cm[:, :, 0].float().contiguous(), yf, hf, chunk=L)
        launches += 1
        y = yf.to(x.dtype)
    else:
        raise ValueError(f"ssd: no kernel for device {x.device}")
    if h0 is not None:
        a_cs = torch.cumsum(dtf * Af[None, None, :], dim=1)     # (B,S,H)
        cdec = Cm[:, :, 0].float()                              # (B,S,N)
        y = y + torch.einsum("bsn,bsh,bhpn->bshp", cdec, torch.exp(a_cs),
                             h0).to(y.dtype)
        hf = hf + h0 * torch.exp(a_cs[:, -1])[..., None, None]  # (B,H,1,1)
    return y, hf
