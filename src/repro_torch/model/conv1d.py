"""TCN-style depthwise conv1d stack — the sensor workload beyond the LSTM.

Port of ``repro/model/conv1d.py``: ``n_blocks`` depthwise, strided 1-D
convolutions (one ``kernel``-tap filter per channel) with the hard
activation the ROM implements between, then a dense readout over the
flattened final feature map — what Stage 1 trains is what the fixed-point
lowering quantizes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import PSpec
from repro_torch.quant.qat import hard_sigmoid, hard_tanh


def conv1d_schema(cfg: ModelConfig):
    c = cfg.conv1d
    blocks = [{
        "w": PSpec((c.kernel, c.channels), dtype=torch.float32),
        "b": PSpec((c.channels,), dtype=torch.float32, init="zeros"),
    } for _ in range(c.n_blocks)]
    return {
        "blocks": blocks,
        "head_w": PSpec((c.flat_features, c.out_features),
                        dtype=torch.float32),
        "head_b": PSpec((c.out_features,), dtype=torch.float32,
                        init="zeros"),
    }


def conv1d_frames(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, S, C) -> (B, T, K, C) strided tap windows, T=(S-K)//stride+1.

    THE framing of the conv1d vertical: the RTL template's emulator and
    float oracle (``repro_torch.rtl.oplib.Conv1dTemplate``) both go through
    this helper.
    """
    return x.unfold(1, kernel, stride).transpose(2, 3)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """x (B, S, C) ⊛ w (K, C) + b (C,), per-channel taps, stride ≥ 1.

    An einsum over :func:`conv1d_frames`, as in the reference: a sum of K
    products per output in IEEE f32 (``F.conv1d`` would run under cuDNN's
    TF32 default on the card)."""
    frames = conv1d_frames(x, int(w.shape[0]), stride)    # (B, T, K, C)
    return torch.einsum("btkc,kc->btc", frames, w) + b


def conv1d_apply(p, x: torch.Tensor, cfg: ModelConfig,
                 state=None) -> Tuple[torch.Tensor, Tuple]:
    """Runs the conv stack over the window; returns (pred (B, out), ())."""
    c = cfg.conv1d
    act = hard_tanh if c.act == "hard_tanh" else hard_sigmoid
    h = x
    for blk in p["blocks"]:
        h = act(depthwise_conv1d(h, blk["w"], blk["b"], c.stride))
    B = h.shape[0]
    pred = h.reshape(B, -1) @ p["head_w"] + p["head_b"]
    return pred, ()


def conv1d_flops(cfg: ModelConfig) -> int:
    """MAC-counted ops per single inference (OP = MAC*2, paper convention)."""
    c = cfg.conv1d
    total = 0
    for t in c.block_lens():
        total += 2 * t * c.kernel * c.channels + t * c.channels  # taps + act
    total += 2 * c.flat_features * c.out_features
    return total
