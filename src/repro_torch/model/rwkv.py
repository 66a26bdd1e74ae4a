"""RWKV-6 ("Finch") block, the RWKV family's layer (port of
``repro/model/rwkv.py``): the time-mix (data-dependent token-shift
interpolation, the decay LoRA, the WKV recurrence, a per-head group norm
and the SiLU gate) and the channel-mix (relu² FFN with a sigmoid gate).
The decode cache of a layer is ``{"wkv": (B, H, N, N) f32, "shift_att",
"shift_ffn": (B, D)}``.

In a step split over ``"model"`` (``layers.Ctx.split``) each rank
computes the time-mix on its block of the heads where they split
(:func:`time_mix_splits`; its ``wkv`` state then holds those heads) and
the channel-mix on its block of ``d_ff`` where that splits, each mixer's
output projection summed over the axis; the shift states stay whole.

Which scan runs (:func:`_wkv_scan`, the one seam): in prefill on a CUDA
tensor the WKV6 kernel B7 (``kernels/rwkv6``), once a layer, the prompt's
tail padded with the identity step (k = 0, w_log = 0) to the multiple of
the chunk its wrapper asks for; on a CPU tensor, and in training on every
device, the chunked form :func:`wkv6_chunked` (B7 is forward-only, as the
reference's template is); a decode step is :func:`wkv6_step`, as in the
reference. A kernel that fails raises; nothing falls back.

The scans: the per-step recurrence y = r·(S + diag(u) k vᵀ), S ←
diag(e^{w}) S + k vᵀ, with S the (N, N) key → value state of each head;
and the chunked form: exact pairwise decays inside 16-step subchunks, the
subchunks chained inside a chunk, the chunk states carried by a segsum
product over the chunk axis. Every decay factor is a difference of running
sums with the later boundary subtracted, so no exponent is positive.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import (Ctx, PSpec, model_sum, pspec,
                                      shard_axis)

SUBCHUNK = 16
MIX_RANK = 32


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    N = cfg.rwkv.head_size
    H = cfg.d_model // N
    return H, N


def time_mix_splits(cfg: ModelConfig, tp: int) -> bool:
    """Whether a split step computes the time-mix as this rank's block
    over a ``"model"`` axis of ``tp``: its heads split over it, and with
    them ``da = H·N`` (:func:`rwkv_time_schema`'s layouts). Where ``da``
    divides the axis but the heads do not, a rank's columns would cut a
    head, so every rank computes the time-mix whole."""
    H, _ = rwkv_dims(cfg)
    return shard_axis(H, tp) == "model"


def rwkv_time_schema(cfg: ModelConfig, tp: int = 16):
    d = cfg.d_model
    H, N = rwkv_dims(cfg)
    da = d  # d_att == d_model in rwkv6
    ha = shard_axis(H, tp)
    aa = shard_axis(da, tp)
    lora = cfg.rwkv.decay_lora
    return {
        "maa_x": PSpec((d,), init="zeros"),
        "maa_wkvrg": PSpec((5, d), init="zeros"),
        "maa_w1": PSpec((d, 5 * MIX_RANK), scale=0.01),
        "maa_w2": PSpec((5, MIX_RANK, d), scale=0.01),
        "decay": PSpec((da,), (aa,), init="zeros"),  # resting log-log decay
        "decay_w1": PSpec((d, lora), scale=0.01),
        "decay_w2": PSpec((lora, da), (None, aa), scale=0.01),
        "u": PSpec((H, N), (ha, None), init="zeros"),  # time_faaaa bonus
        "wr": PSpec((d, da), (None, aa)),
        "wk": PSpec((d, da), (None, aa)),
        "wv": PSpec((d, da), (None, aa)),
        "wg": PSpec((d, da), (None, aa)),
        "ln_x_scale": PSpec((da,), (aa,), init="ones"),
        "ln_x_bias": PSpec((da,), (aa,), init="zeros"),
        "wo": PSpec((da, d), (aa, None)),
    }


def rwkv_channel_schema(cfg: ModelConfig, tp: int = 16):
    d, f = cfg.d_model, cfg.d_ff
    fa = shard_axis(f, tp)
    return {
        "maa_k": PSpec((d,), init="zeros"),
        "maa_r": PSpec((d,), init="zeros"),
        "wk": PSpec((d, f), (None, fa)),
        "wv": PSpec((f, d), (fa, None)),
        "wr": PSpec((d, d)),
    }


def rwkv_state_schema(cfg: ModelConfig, batch: int,
                      dp_axes: Tuple[str, ...] = ("data",), tp: int = 16):
    H, N = rwkv_dims(cfg)
    ha = shard_axis(H, tp)
    bspec = dp_axes if batch >= 16 else None
    return {
        "wkv": PSpec((batch, H, N, N), pspec(bspec, ha, None, None),
                     dtype=torch.float32, init="zeros"),
        "shift_att": PSpec((batch, cfg.d_model), pspec(bspec, None),
                           dtype=torch.bfloat16, init="zeros"),
        "shift_ffn": PSpec((batch, cfg.d_model), pspec(bspec, None),
                           dtype=torch.bfloat16, init="zeros"),
    }


# ---------------------------------------------------------------------------
# WKV6: chunked evaluation + single-step recurrence
# ---------------------------------------------------------------------------



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
    # masked before the exp, as the subchunk pairs are: above the
    # diagonal seg is positive and its exp overflows to inf, whose
    # gradient through a select is 0 · inf = NaN (the reference's
    # ``where(zmask, exp(seg), 0)`` gives NaN gradients there; ROADMAP
    # §C15); the forward is the same
    segd = torch.exp(seg.masked_fill(~zmask, float("-inf")))
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


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w_log: torch.Tensor, u: torch.Tensor,
              h0: Optional[torch.Tensor], chunk: int, mode: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The time-mix's scan over a whole sequence: (y (B,S,H,N) f32, final
    state (B,H,N,N) f32). In training, and on a CPU tensor, the chunked
    form; otherwise the WKV6 kernel B7 (:func:`_wkv_kernel`)."""
    if mode == "train" or r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w_log, u, h0=h0, chunk=chunk)
    return _wkv_kernel(r, k, v, w_log, u, h0, chunk)


def _wkv_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_log: torch.Tensor, u: torch.Tensor,
                h0: Optional[torch.Tensor], chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's wrapper over a sequence of any length, at the chunked form's
    chunk (``min(chunk, S)`` rounded up to a multiple of 16): S padded by
    k = 0, w_log = 0 steps (no decay, no contribution: y of the real steps
    and the final state are unchanged) to a multiple of it, the wrapper's
    conditions, and y sliced back. A CUDA tensor launches the kernel or
    raises; ``meta`` gives the empty results a step is counted on; a CPU
    tensor gets the kernel's plain version."""
    from repro_torch.kernels.rwkv6 import ops

    S = r.shape[1]
    L = -(-min(chunk, S) // SUBCHUNK) * SUBCHUNK
    extra = (-S) % L
    if extra:
        r, k, v, w_log = (F.pad(t, (0, 0, 0, 0, 0, extra))
                          for t in (r, k, v, w_log))
    y, h_final = ops.wkv6(r.float(), k, v, w_log, u, h0, chunk=L)
    return y[:, :S], h_final


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x: (B,S,D); prev: (B,D) last token of the previous segment (or
    None)."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :].to(x.dtype)
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent token-shift interpolation -> (x_w, x_k, x_v, x_r,
    x_g)."""
    delta = xprev - x
    xxx = x + delta * p["maa_x"].to(x.dtype)
    B, S, _ = x.shape
    mix = torch.tanh(xxx @ p["maa_w1"].to(x.dtype)).reshape(B, S, 5,
                                                             MIX_RANK)
    adj = torch.einsum("bsfr,frd->bsfd", mix, p["maa_w2"].to(x.dtype))
    mu = p["maa_wkvrg"].to(x.dtype)[None, None] + adj      # (B,S,5,d)
    return tuple(x + delta * mu[:, :, i] for i in range(5))


def _per_head_groupnorm(y: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, H: int, N: int,
                        eps: float = 1e-5) -> torch.Tensor:
    B, S = y.shape[0], y.shape[1]
    yf = y.reshape(B, S, H, N).float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(B, S, H * N)
    return (yn * scale.float() + bias.float()).to(y.dtype)


def rwkv_time_mix(
    p,
    hx: torch.Tensor,                  # (B,S,D) normed input
    ctx: Ctx,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The time-mix: (out (B, S, D) in hx's dtype, ``{"wkv",
    "shift_att"}`` in prefill and decode, else None). Decode takes one
    position and ``state``; prefill and training run the scan
    (:func:`_wkv_scan`) from ``state["wkv"]`` where given.

    Where the step computes split and the time-mix splits
    (:func:`time_mix_splits`), ``p`` holds this rank's block of the heads
    over ``"model"`` (``wr``/``wk``/``wv``/``wg``/``decay_w2``'s columns,
    ``decay``/``ln_x_*``'s and ``u``'s blocks, ``wo``'s rows) and
    ``state["wkv"]`` its heads: the token shift, the interpolation and
    the decay LoRA's first product run whole, the scan and the per-head
    group norm on the rank's heads, and ``wo``'s partial products are
    summed over the axis. The heads come from the blocks' shapes."""
    cfg = ctx.cfg
    dt = ctx.compute_dtype
    H_whole, N = rwkv_dims(cfg)
    H = p["u"].shape[0]
    split = ctx.split and time_mix_splits(cfg, ctx.tp_size)
    want = H_whole // ctx.tp_size if split else H_whole
    if H != want or p["wr"].shape[-1] != H * N:
        raise ValueError(f"u holds {H} of {H_whole} heads and wr "
                         f"{p['wr'].shape[-1]} columns, not the {want} "
                         f"heads this step computes with")
    B, S, _ = hx.shape
    x = hx.to(dt)

    prev = state["shift_att"] if state is not None else None
    xprev = _token_shift(x, prev)
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xprev)

    dlora = torch.tanh(x_w @ p["decay_w1"].to(dt)) @ p["decay_w2"].to(dt)
    w_log = -torch.exp(p["decay"].float() + dlora.float())   # (B,S,da) <= 0
    r = (x_r @ p["wr"].to(dt)).reshape(B, S, H, N)
    k = (x_k @ p["wk"].to(dt)).reshape(B, S, H, N)
    v = (x_v @ p["wv"].to(dt)).reshape(B, S, H, N)
    g = F.silu(x_g @ p["wg"].to(dt))

    new_state = None
    if ctx.mode == "decode":
        assert state is not None and S == 1
        y1, h_new = wkv6_step(r[:, 0], k[:, 0], v[:, 0],
                              w_log.reshape(B, H, N), p["u"], state["wkv"])
        y = y1[:, None]
        new_state = {"wkv": h_new, "shift_att": x[:, -1]}
    else:
        h0 = state["wkv"] if state is not None else None
        y, h_final = _wkv_scan(r, k, v, w_log.reshape(B, S, H, N), p["u"],
                               h0, cfg.rwkv.chunk, ctx.mode)
        if ctx.mode == "prefill":
            new_state = {"wkv": h_final, "shift_att": x[:, -1]}

    y = y.reshape(B, S, H * N).to(dt)
    y = _per_head_groupnorm(y, p["ln_x_scale"], p["ln_x_bias"], H, N) * g
    out = y @ p["wo"].to(dt)
    if split:
        out = model_sum(out)
    return out.to(hx.dtype), new_state


def rwkv_channel_mix(
    p,
    hx: torch.Tensor,
    ctx: Ctx,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The channel-mix: (out in hx's dtype, ``{"shift_ffn"}`` in prefill
    and decode, else None). Where ``d_ff`` splits over ``"model"``
    (:meth:`Ctx.splits`), ``wk`` holds the rank's columns and ``wv`` its
    rows: the value's partial products are summed over the axis before
    the whole ``wr``'s gate multiplies them."""
    dt = ctx.compute_dtype
    x = hx.to(dt)
    prev = state["shift_ffn"] if state is not None else None
    xprev = _token_shift(x, prev)
    delta = xprev - x
    x_k = x + delta * p["maa_k"].to(dt)
    x_r = x + delta * p["maa_r"].to(dt)
    kk = F.relu(x_k @ p["wk"].to(dt)).square()
    kv = kk @ p["wv"].to(dt)
    if ctx.splits(ctx.cfg.d_ff):
        kv = model_sum(kv)
    out = (torch.sigmoid(x_r @ p["wr"].to(dt)) * kv).to(hx.dtype)
    new_state = None
    if ctx.mode in ("prefill", "decode"):
        new_state = {"shift_ffn": x[:, -1]}
    return out, new_state
