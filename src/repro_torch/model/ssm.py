"""Mamba-2 SSD scans (port of ``ssd_chunked``, ``ssd_step`` and
``ssd_reference`` of ``repro/model/ssm.py``).

The per-step recurrence the SSD chunk-scan kernel (``kernels/mamba2``) is
held against: h ← e^{dt·A} h + (dt·x) ⊗ B, y = h · C; and the chunked form,
whose steps the kernel's three passes follow (each chunk's own state, the
carry over the chunk axis, the intra-chunk products with the chunk's start
state read into y). The Mamba-2 block comes with the Zamba2 family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) log-decays -> (..., L, L) lower-tri pairwise sums."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H) post-softplus, f32
    A: torch.Tensor,        # (H,) negative, f32
    Bm: torch.Tensor,       # (B, S, G, N)
    Cm: torch.Tensor,       # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,      # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N)), f32 (f64 for f64
    inputs).

    1. intra-chunk products; 2. each chunk's own final state; 3. the carry
    over the chunk axis, a small segsum product from ``h0``; 4. each
    chunk's start state read into y. A ragged tail is padded with dt = 0
    (decay 1, no contribution). Products take x's dtype with f32 sums, as
    the reference's ``preferred_element_type`` does.
    """
    Bsz, S, H, Pd = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)   # sums
    G, N = Bm.shape[2], Bm.shape[3]
    S0 = S
    if S % chunk:  # pad tail: dt=0 -> decay exp(0)=1, contribution dt*x=0
        extra = chunk - S % chunk

        def pad(t):
            return torch.cat([t, t.new_zeros((Bsz, extra) + t.shape[2:])], 1)

        x, dt, Bm, Cm = pad(x), pad(dt), pad(Bm), pad(Cm)
        S = S + extra
    nc = S // chunk
    rep = H // G
    cdt = x.dtype           # the caller's compute dtype

    def to_chunks(t):
        return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])

    def f(t):               # a cdt value, summed in acc's dtype
        return t.to(cdt).to(acc)

    dtc = to_chunks(dt.to(acc))                           # (B,c,l,H)
    Bh = f(torch.repeat_interleave(to_chunks(Bm), rep, dim=3))  # (B,c,l,H,N)
    Ch = f(torch.repeat_interleave(to_chunks(Cm), rep, dim=3))
    a = dtc * A.to(acc)[None, None, None, :]              # (B,c,l,H)
    a_t = a.permute(0, 3, 1, 2)                           # (B,H,c,l)
    a_cs = torch.cumsum(a_t, dim=-1)                      # inclusive
    xdt = f(to_chunks(x) * dtc.to(cdt)[..., None])        # (B,c,l,H,P)

    # 1. intra-chunk: y_diag[i] = sum_{j<=i} C_i.B_j L_ij xdt_j
    Lmat = f(torch.exp(_segsum(a_t)))                     # (B,H,c,l,l)
    scores = f(torch.einsum("bclhn,bcshn->bhcls", Ch, Bh) * Lmat)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xdt)

    # 2. chunk-final states: state_c = sum_j exp(a_end - a_j) B_j xdt_j
    decay_states = f(torch.exp(a_cs[..., -1:] - a_cs))    # (B,H,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xdt)

    # 3. inter-chunk recurrence over the (small) chunk axis
    if h0 is None:
        h0 = torch.zeros((Bsz, H, Pd, N), dtype=acc, device=x.device)
    states = torch.cat([h0[:, None].to(acc), states], dim=1)  # (B,c+1,...)
    pad_decay = torch.nn.functional.pad(a_cs[..., -1], (1, 0))  # (B,H,c+1)
    dmat = torch.exp(_segsum(pad_decay))                  # (B,H,c+1,c+1)
    dmat = torch.where(torch.isfinite(dmat), dmat, 0.0)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dmat, states)
    h_prev, h_final = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output for each position (decay from chunk start)
    out_decay = f(torch.exp(a_cs))                        # (B,H,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, f(h_prev), out_decay)

    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)
    return y[:, :S0], h_final


def ssd_step(
    x: torch.Tensor,        # (B, H, P)
    dt: torch.Tensor,       # (B, H) f32 post-softplus
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B, G, N)
    Cm: torch.Tensor,       # (B, G, N)
    h: torch.Tensor,        # (B, H, P, N) f32 (f64 for an f64 run)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the recurrence, in h's dtype. Returns (y
    (B,H,P), h')."""
    G = Bm.shape[1]
    rep = x.shape[1] // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(h.dtype)   # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(h.dtype)
    da = torch.exp(dt * A[None, :])                         # (B,H)
    xf = x.to(h.dtype)
    h_new = h * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xf * dt[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive per-step recurrence. x:(B,S,H,P) dt:(B,S,H) B/C:(B,S,G,N).
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32; f64
    throughout for f64 inputs)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    h = (torch.zeros((Bsz, H, Pd, N), dtype=ct, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        y, h = ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h
