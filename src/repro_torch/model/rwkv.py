"""RWKV-6 WKV scans (port of ``wkv6_chunked``, ``wkv6_step`` and
``wkv6_reference`` of ``repro/model/rwkv.py``).

The per-step recurrence the WKV6 kernel (``kernels/rwkv6``) is held
against: y = r·(S + diag(u) k vᵀ), S ← diag(e^{w}) S + k vᵀ, with S the
(N, N) key → value state of each head; and the chunked form: exact
pairwise decays inside 16-step subchunks, the subchunks chained inside a
chunk, the chunk states carried by a segsum product over the chunk axis.
Every decay factor is a difference of running sums with the later boundary
subtracted, so no exponent is positive. The RWKV-6 block comes with the
RWKV family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

SUBCHUNK = 16


def wkv6_chunked(
    r: torch.Tensor,      # (B, S, H, N)
    k: torch.Tensor,      # (B, S, H, N)
    v: torch.Tensor,      # (B, S, H, N)
    w_log: torch.Tensor,  # (B, S, H, N) log-decay, <= 0, f32
    u: torch.Tensor,      # (H, N)
    h0: Optional[torch.Tensor] = None,   # (B, H, N, N) key->value state
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,N), final_state (B,H,N,N)), f32 (f64 for f64
    inputs). The chunk is rounded up to a multiple of 16; a ragged tail is
    padded with w_log = 0 and k = 0 (no decay, no contribution). Products
    take r's dtype with f32 sums, as the reference's
    ``preferred_element_type`` does."""
    B, S, H, N = r.shape
    chunk = min(chunk, S)
    chunk = ((chunk + SUBCHUNK - 1) // SUBCHUNK) * SUBCHUNK
    S0 = S
    if S % chunk:
        extra = chunk - S % chunk

        def pad(t):
            return torch.cat([t, t.new_zeros((B, extra, H, N))], 1)

        r, k, v, w_log = pad(r), pad(k), pad(v), pad(w_log)
        S = S + extra
    nc = S // chunk
    l = min(SUBCHUNK, chunk)
    ns = chunk // l
    dt = r.dtype            # the caller's compute dtype
    acc = torch.promote_types(dt, torch.float32)   # sums

    def f(t):               # a dt value, summed in acc's dtype
        return t.to(dt).to(acc)

    def shape_cs(t):  # (B,S,H,N) -> (B,nc,ns,l,H,N)
        return t.reshape(B, nc, ns, l, H, N)

    rc, kc, vc = (f(shape_cs(t)) for t in (r, k, v))
    wc = shape_cs(w_log.to(acc))
    csub = torch.cumsum(wc, dim=3)                    # within-subchunk
    cprev = csub - wc                                 # exclusive
    sub_tot = csub[:, :, :, -1]                       # (B,nc,ns,H,N)

    # intra-subchunk exact pairwise: A[i,j] = sum_n r_i k_j e^{cprev_i -
    # csub_j} (j < i); the diagonal takes the bonus u
    pair = cprev[:, :, :, :, None] - csub[:, :, :, None, :]  # (..,l,l,H,N)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=r.device),
                      -1)[None, None, None, :, :, None, None]
    dec = f(torch.exp(pair.masked_fill(~mask, float("-inf"))))
    Am = torch.einsum("bcsihn,bcsijhn,bcsjhn->bcsijh", rc, dec, kc)
    A_diag = torch.einsum("bcsihn,hn,bcsihn->bcsih", rc, f(u), kc)
    Am = Am + torch.einsum("bcsih,ij->bcsijh", A_diag,
                           torch.eye(l, dtype=acc, device=r.device))
    y = torch.einsum("bcsijh,bcsjhn->bcsihn", f(Am), vc)

    # per-subchunk totals T_a = sum_j (k_j e^{sub_tot - csub_j}) v_j^T
    kdec = f(kc * torch.exp(sub_tot[:, :, :, None] - csub))
    T = torch.einsum("bcsjhn,bcsjhp->bcshnp", kdec, vc)   # (B,nc,ns,H,N,N)

    # within-chunk subchunk carry: s_a, the state at subchunk a's start
    # relative to the chunk's
    s = torch.zeros((B, nc, H, N, N), dtype=acc, device=r.device)
    s_list = []
    for a in range(ns):
        s_list.append(s)
        s = s * torch.exp(sub_tot[:, :, a])[..., None] + T[:, :, a]
    chunk_T = s
    s_stack = torch.stack(s_list, dim=2)              # (B,nc,ns,H,N,N)
    rdec = f(rc * torch.exp(cprev))
    y = y + torch.einsum("bcsihn,bcshnp->bcsihp", rdec, f(s_stack))

    # chunk-level carry: a segsum product over the chunk axis
    chunk_tot = wc.sum(dim=(2, 3))                    # (B,nc,H,N)
    if h0 is None:
        h0 = torch.zeros((B, H, N, N), dtype=acc, device=r.device)
    states = torch.cat([h0[:, None].to(acc), chunk_T], dim=1)
    cs = torch.cumsum(torch.nn.functional.pad(chunk_tot, (0, 0, 0, 0, 1, 0)),
                      dim=1)                          # (B,nc+1,H,N)
    seg = cs[:, :, None] - cs[:, None, :]             # (B,z,c,H,N) z >= c
    zmask = torch.tril(torch.ones((nc + 1, nc + 1), dtype=torch.bool,
                                  device=r.device))[None, :, :, None, None]
    segd = torch.where(zmask, torch.exp(seg), 0.0)
    h_all = torch.einsum("bzchn,bchnp->bzhnp", segd, states)
    h_prev, h_final = h_all[:, :-1], h_all[:, -1]

    # r's decay from the chunk start: earlier subchunks' totals + cprev
    sub_cum = torch.cumsum(sub_tot, dim=2) - sub_tot  # exclusive
    r_chunk_dec = f(rc * torch.exp(sub_cum[:, :, :, None] + cprev))
    y = y + torch.einsum("bcsihn,bchnp->bcsihp", r_chunk_dec, f(h_prev))
    return y.reshape(B, S, H, N)[:, :S0], h_final


def wkv6_step(r, k, v, w_log, u, h):
    """Single decode step, in h's dtype (f32; f64 for an f64 run).
    r/k/v/w_log: (B,H,N); h: (B,H,N,N) key->value."""
    ct = h.dtype
    rf, kf, vf = r.to(ct), k.to(ct), v.to(ct)
    bonus = torch.einsum("bhn,hn,bhn->bh", rf, u.to(ct), kf)
    y = torch.einsum("bhn,bhnp->bhp", rf, h) + bonus[..., None] * vf
    h_new = h * torch.exp(w_log.to(ct))[..., None] \
        + torch.einsum("bhn,bhp->bhnp", kf, vf)
    return y.to(r.dtype), h_new


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive scan oracle. r/k/v/w_log: (B,S,H,N); u: (H,N). Returns
    (y (B,S,H,N) in r's dtype, final state (B,H,N,N) f32; f64 throughout
    for f64 inputs)."""
    B, S, H, N = r.shape
    ct = torch.promote_types(r.dtype, torch.float32)
    h = (torch.zeros((B, H, N, N), dtype=ct, device=r.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        y, h = wkv6_step(r[:, t], k[:, t], v[:, t], w_log[:, t], u, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h
