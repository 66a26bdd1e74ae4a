"""The plain reference of a dense decoder of the Llama form, as Yi-9B is
published (arXiv:2403.04652; its ``config.json``): token embedding; per
layer RMSNorm, grouped-query attention with rotary positions (the
rotate-half form, frequencies ``theta^(-i / (hd/2))``), a residual add,
RMSNorm, a SwiGLU MLP, a residual add; a final RMSNorm and an untied
output head.

Plain PyTorch in float32 with TF32 off (the caller sets it, see
:func:`ieee_f32`), one sequence at a time and one layer at a time, each
layer's weights cast to float32 as it is reached, so that it fits beside
the served model's weights. It imports nothing of the program.

``mm`` is every matrix product: :func:`mm_f32` for the reference,
:func:`mm_fp8` for the control, which rounds both operands of each
product to float8 e4m3 (a scale per row of the activations and per column
of the weights), the step below the bfloat16 the configuration serves in.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

#: e4m3's largest finite value
E4M3_MAX = 448.0


def ieee_f32() -> None:
    """Float32 products in IEEE float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.float() @ w.float()


def _e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale along ``dim``'s slices (its
    absolute maximum maps to the format's largest value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def mm_fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _e4m3(a.float(), -1) @ _e4m3(w.float(), -2)


def value(c: Dict, key: str):
    """``key`` of the configuration's file: as its source gives it, or,
    where no file of the repository bears the value out, from its
    ``unverified`` group."""
    return c[key] if key in c else c["unverified"][key]


def sizes(c: Dict) -> Dict[str, int]:
    hd = c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]
    return dict(L=c["num_hidden_layers"], D=c["hidden_size"],
                H=c["num_attention_heads"], KV=c["num_key_value_heads"],
                hd=hd, F=c["intermediate_size"], V=c["vocab_size"])


def layout(c: Dict) -> Dict:
    """The weights' tree: each leaf (shape, kind), layers stacked on a
    leading axis, under the names the served program's parameter tree
    uses."""
    s = sizes(c)
    L, D, H, KV, hd, F, V = (s[k] for k in ("L", "D", "H", "KV", "hd", "F",
                                           "V"))
    return {
        "embed": {"embedding": ((V, D), "embedding"),
                  "lm_head": ((D, V), "matrix")},
        "g0": {
            "norm1": {"scale": ((L, D), "scale")},
            "attn": {"wq": ((L, D, H * hd), "matrix"),
                     "wk": ((L, D, KV * hd), "matrix"),
                     "wv": ((L, D, KV * hd), "matrix"),
                     "wo": ((L, H * hd, D), "matrix")},
            "norm2": {"scale": ((L, D), "scale")},
            "mlp": {"w_gate": ((L, D, F), "matrix"),
                    "w_up": ((L, D, F), "matrix"),
                    "wo": ((L, F, D), "matrix")},
        },
        "final_norm": {"scale": ((D,), "scale")},
    }


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(S, heads, hd): position p rotates the pair (i, i + hd/2) by
    ``p * theta^(-i / (hd/2))``."""
    S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, q (S, H, hd), k/v (S, KV, hd): one kv
    head's group of q heads at a time."""
    S, H, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    out = torch.empty_like(q)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    for j in range(KV):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)          # (g, S, hd)
        s = (qj @ k[:, j].T) * hd ** -0.5                     # (g, S, S)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[:, j * g:(j + 1) * g] = (s @ v[:, j]).transpose(0, 1)
        del s
    return out


def logits(w: Dict, c: Dict, tokens: torch.Tensor, start: int,
           mm: Callable = mm_f32) -> torch.Tensor:
    """(S - start, V) float32: the logits at positions ``start``..S-1 of
    the sequence ``tokens`` (S,), each the distribution of the token that
    follows."""
    s = sizes(c)
    eps = float(value(c, "rms_norm_eps"))
    theta = float(value(c, "rope_theta"))
    S, H, KV, hd = tokens.shape[0], s["H"], s["KV"], s["hd"]
    g = w["g0"]
    x = w["embed"]["embedding"][tokens].float()
    for i in range(s["L"]):
        h = _rmsnorm(x, g["norm1"]["scale"][i], eps)
        a = g["attn"]
        q = _rope(mm(h, a["wq"][i]).reshape(S, H, hd), theta)
        k = _rope(mm(h, a["wk"][i]).reshape(S, KV, hd), theta)
        v = mm(h, a["wv"][i]).reshape(S, KV, hd)
        o = _attention(q, k, v).reshape(S, H * hd)
        x = x + mm(o, a["wo"][i])
        h = _rmsnorm(x, g["norm2"]["scale"][i], eps)
        m = g["mlp"]
        u = torch.nn.functional.silu(mm(h, m["w_gate"][i])) * mm(h,
                                                                 m["w_up"][i])
        x = x + mm(u, m["wo"][i])
    h = _rmsnorm(x[start:], w["final_norm"]["scale"], eps)
    return mm(h, w["embed"]["lm_head"])


# ---------------------------------------------------------------------------
# The model's work, for the shares of peak: what the function needs, not
# what the program does (no padding, repeated K/V or unread cache rows).
# ---------------------------------------------------------------------------

def _matmul_params(c: Dict) -> int:
    """Weights of one layer's matrix products."""
    s = sizes(c)
    return (s["D"] * (s["H"] + 2 * s["KV"]) * s["hd"] + s["H"] * s["hd"]
            * s["D"] + 3 * s["D"] * s["F"])


def prefill_flops(c: Dict, n: int) -> int:
    """A prefill of ``n`` tokens: every layer's products at each position,
    causal attention (4 hd flops a scored pair and q head) and the head
    at the last position, whose logits are the first token's."""
    s = sizes(c)
    pairs = n * (n + 1) // 2
    return (s["L"] * (2 * _matmul_params(c) * n
                      + 4 * s["hd"] * s["H"] * pairs)
            + 2 * s["D"] * s["V"])


def decode_flops(c: Dict, ctx: int) -> int:
    """One decoded token whose attention reads ``ctx`` positions (itself
    included)."""
    s = sizes(c)
    return (s["L"] * (2 * _matmul_params(c) + 4 * s["hd"] * s["H"] * ctx)
            + 2 * s["D"] * s["V"])
