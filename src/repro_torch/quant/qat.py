"""Quantization-aware training for translatable components (port of
``repro/quant/qat.py``).

The paper's Stage-1 loop: train with fake-quantized weights/activations so
the translated fixed-point accelerator matches the evaluated accuracy.
Includes the FPGA-friendly piecewise-linear activations
(``hard_sigmoid``/``hard_tanh``) the RTL templates implement as LUT-free
comparators; they also generate the templates' activation ROM tables.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.model.layers import tree_map
from repro_torch.quant.fixedpoint import FxpFormat, fake_quant


@dataclass(frozen=True)
class QATConfig:
    weight_fmt: FxpFormat = FxpFormat(8, 6)
    act_fmt: FxpFormat = FxpFormat(8, 4)
    accum_fmt: FxpFormat = FxpFormat(16, 8)   # DSP accumulator width
    hard_activations: bool = True             # PWL sigmoid/tanh (RTL-style)
    quantize_activations: bool = True


@functools.lru_cache(maxsize=None)
def _bound(value: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A 0-d constant on ``device``, made once (never written to)."""
    return torch.tensor(value, dtype=dtype, device=device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``'s function and gradient: min/max against tensor bounds
    split the gradient at a tie (0.5 each side), where ``torch.clamp``
    passes all of it. Under QAT ties happen: ±2.5 and ±1 are exact codes
    of the accumulator format."""
    return torch.minimum(torch.maximum(x, _bound(lo, x.dtype, x.device)),
                         _bound(hi, x.dtype, x.device))


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """PWL sigmoid: exact at 0/±2.5, slope 0.2 — one comparator + shift-add."""
    return _clip(0.2 * x + 0.5, 0.0, 1.0)


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    return _clip(x, -1.0, 1.0)


def fake_quant_tree(params, fmt: FxpFormat):
    """Fake-quantize every ≥2-D tensor (weights); leave biases full-width."""
    return tree_map(lambda p: fake_quant(p, fmt) if p.ndim >= 2 else p,
                    params)


def make_qat_lstm_apply(cfg: ModelConfig, qcfg: QATConfig):
    """Quantized version of the paper's LSTM graph (see model/lstm.py).

    Mirrors what the generated RTL computes: Q-format weights, activations
    re-quantized after every nonlinearity, wide accumulator for the MACs.
    Gate order i, f, g, o; the quantizations come in the reference's order,
    step for step.
    """
    sig = hard_sigmoid if qcfg.hard_activations else torch.sigmoid
    th = hard_tanh if qcfg.hard_activations else torch.tanh

    def aq(x):
        return fake_quant(x, qcfg.act_fmt) if qcfg.quantize_activations else x

    def cell_step(wq, bq, x_t, h, c):
        z = torch.cat([x_t, h], dim=-1) @ wq + bq
        z = fake_quant(z, qcfg.accum_fmt)          # accumulator truncation
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c_new = aq(sig(f)) * c + aq(sig(i)) * aq(th(g))
        c_new = fake_quant(c_new, qcfg.accum_fmt)
        h_new = aq(sig(o)) * aq(th(c_new))
        return aq(h_new), c_new

    def apply(params, x, state=None):
        c = cfg.lstm
        B, S, _ = x.shape
        seq = aq(x)
        h_states = []
        for li, cell in enumerate(params["cells"]):
            h = x.new_zeros((B, c.hidden)) if state is None else state[li][0]
            cc = x.new_zeros((B, c.hidden)) if state is None else state[li][1]
            # the reference quantizes w and b inside every step; XLA hoists
            # that loop-invariant work out of its unrolled loop, and so do
            # we: the same arithmetic, once a cell
            wq = fake_quant(cell["w"], qcfg.weight_fmt)
            bq = fake_quant(cell["b"], qcfg.accum_fmt)
            outs = []
            for t in range(S):
                h, cc = cell_step(wq, bq, seq[:, t], h, cc)
                outs.append(h)
            seq = torch.stack(outs, dim=1)
            h_states.append((h, cc))
        wq = fake_quant(params["head_w"], qcfg.weight_fmt)
        pred = seq[:, -1] @ wq + params["head_b"]
        return pred, tuple(h_states)

    return apply


def make_qat_loss(cfg: ModelConfig, qcfg: QATConfig):
    apply = make_qat_lstm_apply(cfg, qcfg)

    def loss_fn(params, batch):
        pred, _ = apply(params, batch["x"])
        loss = torch.mean(torch.square(pred - batch["y"]))
        return loss, {"loss": loss}

    return loss_fn
