"""Mamba-2 (SSD) block, the hybrid family's layer (port of
``repro/model/ssm.py``).

The block: z/x/B/C/dt projections, a width-4 depthwise causal conv with
SiLU on x, B and C, the SSD scan, the skip ``D·x``, a gated RMS norm and
the output projection. The decode cache of a layer is ``{"ssm": (B, H, P,
N) f32, "conv_x"/"conv_B"/"conv_C": the last W-1 pre-conv inputs}``.

Which scan runs (:func:`_ssd_scan`, the one seam): in prefill on a CUDA
tensor the SSD chunk-scan kernel B6 (``kernels/mamba2``), once a layer, the
prompt's tail padded with the identity step (dt = 0) to the multiple of
the chunk its wrapper asks for; on a CPU tensor, and in training on every
device, the chunked form :func:`ssd_chunked` (B6 is forward-only, as the
reference's template is); a decode step is :func:`ssd_step`, as in the
reference (no kernel takes one step). A kernel that fails raises; nothing
falls back.

The scans: the per-step recurrence h ← e^{dt·A} h + (dt·x) ⊗ B, y = h · C
(:func:`ssd_step`, :func:`ssd_reference`), and the chunked form, whose
steps the kernel's three passes follow (each chunk's own state, the carry
over the chunk axis, the intra-chunk products with the chunk's start state
read into y).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import (Ctx, PSpec, model_sum, pspec,
                                      shard_axis)

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    return d_inner, n_heads, s.headdim, s.d_state


def mixer_splits(cfg: ModelConfig, tp: int) -> bool:
    """Whether a split step computes the mixer as this rank's block over
    a ``"model"`` axis of ``tp``: ``d_inner`` and the heads both split
    over it (:func:`mamba_schema`'s layouts) and B and C are one group,
    whole on every rank. Otherwise every rank computes it whole."""
    d_inner, H, _, _ = mamba_dims(cfg)
    return (cfg.ssm.n_groups == 1 and shard_axis(d_inner, tp) == "model"
            and shard_axis(H, tp) == "model")


def mamba_schema(cfg: ModelConfig, tp: int = 16):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, _, N = mamba_dims(cfg)
    gN = s.n_groups * N
    ia = shard_axis(d_inner, tp)
    ha = shard_axis(H, tp)
    w = s.conv_width
    return {
        "w_z": PSpec((d, d_inner), (None, ia)),
        "w_x": PSpec((d, d_inner), (None, ia)),
        "w_B": PSpec((d, gN), (None, None)),
        "w_C": PSpec((d, gN), (None, None)),
        "w_dt": PSpec((d, H), (None, ha)),
        "conv_x": PSpec((w, d_inner), (None, ia), scale=0.5),
        "conv_B": PSpec((w, gN), (None, None), scale=0.5),
        "conv_C": PSpec((w, gN), (None, None), scale=0.5),
        "A_log": PSpec((H,), (ha,), init="zeros"),   # A = -exp(A_log) = -1
        "dt_bias": PSpec((H,), (ha,), init="zeros"),
        "D": PSpec((H,), (ha,), init="ones"),
        "norm_scale": PSpec((d_inner,), (ia,), init="ones"),
        "w_out": PSpec((d_inner, d), (ia, None)),
    }


def mamba_state_schema(cfg: ModelConfig, batch: int,
                       dp_axes: Tuple[str, ...] = ("data",), tp: int = 16):
    s = cfg.ssm
    d_inner, H, Pd, N = mamba_dims(cfg)
    gN = s.n_groups * N
    ha = shard_axis(H, tp)
    ia = shard_axis(d_inner, tp)
    # batch-replicated states are tiny for B=1 (long_500k); shard otherwise
    bspec = dp_axes if batch >= 16 else None
    w = s.conv_width
    return {
        "ssm": PSpec((batch, H, Pd, N), pspec(bspec, ha, None, None),
                     dtype=torch.float32, init="zeros"),
        "conv_x": PSpec((batch, w - 1, d_inner), pspec(bspec, None, ia),
                        dtype=torch.bfloat16, init="zeros"),
        "conv_B": PSpec((batch, w - 1, gN), pspec(bspec, None, None),
                        dtype=torch.bfloat16, init="zeros"),
        "conv_C": PSpec((batch, w - 1, gN), pspec(bspec, None, None),
                        dtype=torch.bfloat16, init="zeros"),
    }


# ---------------------------------------------------------------------------
# Depthwise causal conv (train/prefill over the sequence, decode a step)
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (W, C) depthwise. Causal: y_t = sum_k w[k]
    x_{t-W+1+k}, then SiLU."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for k in range(W):
        y = y + pad[:, k:k + x.shape[1], :] * w[k][None, None, :]
    return F.silu(y)


def _conv_step(x_t: torch.Tensor, prev: torch.Tensor, w: torch.Tensor):
    """x_t: (B, C); prev: (B, W-1, C) rolling window. Returns (y_t,
    new_prev)."""
    window = torch.cat([prev, x_t[:, None, :]], dim=1)      # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(y).to(x_t.dtype), window[:, 1:, :]


def _conv_tail(t: torch.Tensor, W: int) -> torch.Tensor:
    """The last W-1 positions of t (B, S, C), zeros in front where S <
    W-1: the decode conv's window after a prefill."""
    if t.shape[1] < W - 1:
        t = F.pad(t, (0, 0, W - 1 - t.shape[1], 0))
    return t[:, -(W - 1):, :]


# ---------------------------------------------------------------------------
# SSD chunked scan (the matmul-form state-space dual)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Full block apply
# ---------------------------------------------------------------------------


def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
              h0: Optional[torch.Tensor], mode: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's scan over a whole sequence: (y (B,S,H,P) f32, final
    state (B,H,P,N) f32). In training, and on a CPU tensor, the chunked
    form; otherwise the SSD kernel B6 (:func:`_ssd_kernel`)."""
    if mode == "train" or x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return _ssd_kernel(x, dt, A, Bm, Cm, chunk, h0)


def _ssd_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's wrapper over a sequence of any length: S padded by dt = 0
    steps (decay 1, no contribution: y of the real steps and the final
    state are unchanged) to a multiple of ``chunk``, the wrapper's
    condition, and y sliced back. A CUDA tensor launches the kernel or
    raises; ``meta`` gives the empty results a step is counted on; a CPU
    tensor gets the kernel's plain version."""
    from repro_torch.kernels.mamba2 import ops

    S = x.shape[1]
    extra = (-S) % chunk
    if extra:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, extra))
                         for t in (x, dt, Bm, Cm))
    y, h_final = ops.ssd(x.float(), dt, A, Bm, Cm, h0, chunk=chunk)
    return y[:, :S], h_final


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5, width: int = 0) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` over its last dim. ``width``: that
    dim's whole size where ``y`` holds this rank's block of it over
    ``"model"``; the mean of squares is then the ranks' sums summed over
    the axis, over ``width``."""
    yf = (y * F.silu(z)).float()
    if not width or width == yf.shape[-1]:
        ms = yf.square().mean(-1, keepdim=True)
    else:
        ms = model_sum(yf.square().sum(-1, keepdim=True)) / width
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def mamba_apply(
    p,
    hx: torch.Tensor,                    # (B, S, D) normed input
    ctx: Ctx,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba-2 mixer: (out (B, S, D) in hx's dtype, the new decode
    state in prefill and decode, else None). Decode takes one position and
    ``state``; prefill and training run the scan (:func:`_ssd_scan`) over
    the sequence from ``state["ssm"]`` where given.

    Where the step computes split and the mixer splits
    (:func:`mixer_splits`), ``p`` and ``state`` hold this rank's block of
    ``d_inner`` and its heads over ``"model"``: the scan runs on its
    heads, the gated norm sums its squares over the axis and ``w_out``'s
    partial products are summed over it. The widths come from the
    blocks' shapes."""
    cfg = ctx.cfg
    s = cfg.ssm
    dt_ = ctx.compute_dtype
    d_whole, _, Pd, N = mamba_dims(cfg)
    d_inner, H = p["w_x"].shape[-1], p["w_dt"].shape[-1]
    split = ctx.split and mixer_splits(cfg, ctx.tp_size)
    want = d_whole // ctx.tp_size if split else d_whole
    if d_inner != want:
        raise ValueError(f"w_x holds {d_inner} of d_inner {d_whole}, not "
                         f"the {want} this step computes with")
    G = s.n_groups
    B, S, _ = hx.shape
    hc = hx.to(dt_)

    z = hc @ p["w_z"].to(dt_)                            # (B,S,d_inner)
    x = hc @ p["w_x"].to(dt_)
    Bm = hc @ p["w_B"].to(dt_)                           # (B,S,gN)
    Cm = hc @ p["w_C"].to(dt_)
    dt_raw = hc @ p["w_dt"].to(dt_)                      # (B,S,H)
    dt_f = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()

    new_state = None
    if ctx.mode == "decode":
        assert state is not None and S == 1
        xs, cx = _conv_step(x[:, 0], state["conv_x"].to(dt_), p["conv_x"])
        Bs, cB = _conv_step(Bm[:, 0], state["conv_B"].to(dt_), p["conv_B"])
        Cs, cC = _conv_step(Cm[:, 0], state["conv_C"].to(dt_), p["conv_C"])
        y, h_new = ssd_step(xs.reshape(B, H, Pd), dt_f[:, 0], A,
                            Bs.reshape(B, G, N), Cs.reshape(B, G, N),
                            state["ssm"])
        y = y + D[None, :, None] * xs.reshape(B, H, Pd)
        y = y.reshape(B, 1, d_inner).to(dt_)
        new_state = {"ssm": h_new, "conv_x": cx.to(x.dtype),
                     "conv_B": cB.to(x.dtype), "conv_C": cC.to(x.dtype)}
    else:
        xc = _causal_conv(x, p["conv_x"].to(dt_))
        Bc = _causal_conv(Bm, p["conv_B"].to(dt_))
        Cc = _causal_conv(Cm, p["conv_C"].to(dt_))
        h0 = state["ssm"] if state is not None else None
        y4, h_final = _ssd_scan(
            xc.reshape(B, S, H, Pd), dt_f, A, Bc.reshape(B, S, G, N),
            Cc.reshape(B, S, G, N), min(s.chunk, S), h0, ctx.mode)
        y4 = y4 + (D[None, None, :, None]
                   * xc.reshape(B, S, H, Pd).float()).to(y4.dtype)
        y = y4.reshape(B, S, d_inner).to(dt_)
        if ctx.mode == "prefill":
            W = s.conv_width
            new_state = {"ssm": h_final,
                         "conv_x": _conv_tail(x, W).to(x.dtype),
                         "conv_B": _conv_tail(Bm, W).to(x.dtype),
                         "conv_C": _conv_tail(Cm, W).to(x.dtype)}

    yn = _gated_rmsnorm(y, z, p["norm_scale"], width=d_whole)
    out = yn @ p["w_out"].to(dt_)
    if split:
        out = model_sum(out)
    return out.to(hx.dtype), new_state
