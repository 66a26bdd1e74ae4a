"""Post-training int8 quantization (port of ``repro/quant/ptq.py``).

Weights are quantized symmetric per output channel to int8 codes + f32
scales; ``kernels/quant_matmul`` is the template that consumes this layout
(int8 × int8 → int32 MAC, rescale on the way out) and
:func:`int8_matmul_ref` is its oracle. The codes keep the reference's
logical shape (..., K, N) and are stored K-major (:func:`k_major`);
:func:`dequantize_params` and :func:`int8_matmul_ref` read them by value
and return row-major tensors, as from row-major codes. Trees are nested dicts / lists /
tuples of tensors, walked in ``jax.tree.flatten``'s order (sorted dict
keys) as :func:`repro_torch.model.layers.tree_map` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.kernels.quant_matmul.ref import int8_dot
from repro_torch.model.layers import tree_leaves, tree_map


@dataclass
class Int8Params:
    q: Any        # int8 codes, same tree structure as the source weights
    scale: Any    # f32 per-output-channel scales (1, out) per leaf
    skipped: Any  # leaves kept in full precision (ndim < 2)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The same values with the last two dimensions stored K-major: a
    (..., K, N) leaf gets strides (..., 1, K), each output channel's K
    codes contiguous, which is what B4's tensor-core and decode kernels
    read. A one-off copy at quantization."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quant_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return k_major(q.to(torch.int8)), scale.float()


def quantize_params_int8(params) -> Int8Params:
    """Every floating leaf of rank >= 2 -> (codes, scales); the others are
    kept in ``skipped``. ``None`` marks the missing side of each leaf."""
    qs, scales, skipped = [], [], []
    for leaf in tree_leaves(params):
        leaf = torch.as_tensor(leaf)
        if leaf.ndim >= 2 and leaf.is_floating_point():
            q, s = _quant_leaf(leaf)
            qs.append(q), scales.append(s), skipped.append(None)
        else:
            qs.append(None), scales.append(None), skipped.append(leaf)

    def rebuild(values):
        it = iter(values)
        return tree_map(lambda _: next(it), params)

    return Int8Params(q=rebuild(qs), scale=rebuild(scales),
                      skipped=rebuild(skipped))


def dequantize_params(ip: Int8Params, dtype: torch.dtype = torch.bfloat16):
    """codes * scales in ``dtype``, each leaf row-major (contiguous) whatever
    the layout of its codes."""
    def deq(q, s, skip):
        if q is None:
            return skip
        return (q.float() * s).to(dtype).contiguous()

    return tree_map(deq, ip.q, ip.scale, ip.skipped,
                    is_leaf=lambda x: x is None)


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    act_amax: float = 0.0) -> torch.Tensor:
    """Oracle for kernels/quant_matmul: dynamic per-tensor activation quant,
    int8×int8→int32 MAC, rescale to f32. x: (..., K), wq: (K, N) int8."""
    xf = x.float()
    amax = (xf.abs().max() if act_amax == 0.0
            else torch.tensor(act_amax, dtype=torch.float32, device=x.device))
    xs = torch.clamp_min(amax, 1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return int8_dot(xq, wq).float() * xs * scale.reshape(1, -1)
