"""Plain PyTorch version of the fused integer LSTM window (port of
``repro/kernels/lstm_cell_int/ref.py::lstm_window_int_ref``).

One timestep at a time, in int32, through a MAC callable: the plain MAC
(:func:`~repro_torch.kernels.mac_int.ref.mac_int_ref`, exact int64 column
products) here, the MAC kernel's wrapper in the emulator's per-step
``pallas`` schedule. Runs on the CPU and on CUDA alike.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.lstm_cell_int.kernel import CellSpec
from repro_torch.kernels.mac_int.ref import mac_int_ref
from repro_torch.quant.fixedpoint import fxp_requant_int


def lstm_window_steps(x, w, b, sig_table, tanh_table, *, spec: CellSpec,
                      mac: Callable[..., torch.Tensor]) -> torch.Tensor:
    """(B, S, d_in) int codes -> (B, S, hidden) int32, one ``mac(xh, w, b,
    shift=, lo=, hi=)`` call per timestep for the gate pre-activations."""
    A, C = spec.act_fmt, spec.state_fmt
    af, cf = A.frac_bits, C.frac_bits
    B, H = x.shape[0], spec.hidden
    h = torch.zeros((B, H), dtype=torch.int32, device=x.device)
    c = torch.zeros((B, H), dtype=torch.int32, device=x.device)

    def sig(v):
        return sig_table[(v - spec.sig_lo).long()]

    def tanh(v):
        return tanh_table[(v - spec.tanh_lo).long()]

    outs = []
    for t in range(spec.seq_len):
        xh = torch.cat([x[:, t].to(torch.int32), h], dim=-1)
        z = mac(xh, w, b, shift=spec.w_fmt.frac_bits, lo=A.lo, hi=A.hi)
        i, f, g, o = torch.split(z, H, dim=-1)
        si, sf, so, tg = sig(i), sig(f), sig(o), tanh(g)
        # align si*tg (scale 2·af) to sf*c (af+cf): << (cf - af)
        term = sf * c + ((si * tg) << (cf - af))
        c = fxp_requant_int(term, af + cf, C)
        c_a = fxp_requant_int(c, cf, A)
        h = fxp_requant_int(so * tanh(c_a), 2 * af, A)
        outs.append(h)
    return torch.stack(outs, dim=1)


def lstm_window_int_ref(x, w, b, sig_table, tanh_table, *,
                        spec: CellSpec) -> torch.Tensor:
    """(B, S, d_in) int codes -> (B, S, hidden) int32, per-step schedule."""
    return lstm_window_steps(x, w, b, sig_table, tanh_table, spec=spec,
                             mac=mac_int_ref)
