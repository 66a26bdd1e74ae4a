"""Public wrapper of the fused integer LSTM-window template (B1)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.lstm_cell_int.kernel import (CellSpec,
                                                      check_w_codes,
                                                      lstm_window_int_cuda,
                                                      mma_takes)
from repro_torch.kernels.lstm_cell_int.ref import lstm_window_int_ref

#: kernel launches made by :func:`lstm_window_int` (CPU calls do not count)
launches = 0
#: ... and by the variant :func:`variant` chose
launches_by_variant = {"mma": 0, "simt": 0}


def variant(spec: CellSpec, w: Optional[torch.Tensor] = None) -> str:
    """The kernel a CUDA call with this cell and this W launches:
    ``"mma"`` (the gate product on the int8 tensor cores) where the spec's
    codes fit int8 and the sum cannot wrap
    (:func:`~repro_torch.kernels.lstm_cell_int.kernel.mma_takes`; Table I
    and every 8-bit cell of the repo's designs) and ``w`` holds
    ``spec.w_fmt`` codes, ``"simt"`` (int32 on the CUDA cores, exact for
    any codes) for the rest. A W outside its format (an SEU model's flipped
    bit) is a routing rule between the two kernels, counted under
    ``launches_by_variant["simt"]``: nothing falls back to the plain
    version. W's range is read once per version of the tensor
    (:func:`~repro_torch.kernels.lstm_cell_int.kernel.check_w_codes`),
    which syncs; without ``w`` the answer is the spec's alone."""
    if not mma_takes(spec):
        return "simt"
    return "mma" if w is None or check_w_codes(w, spec) else "simt"


def _check(x, w, b, sig_table, tanh_table, spec: CellSpec) -> None:
    H, d_in = spec.hidden, spec.d_in
    operands = {"x": (x, (*x.shape[:1], spec.seq_len, d_in)),
                "w": (w, (d_in + H, 4 * H)), "b": (b, (4 * H,)),
                "sig_table": (sig_table, tuple(sig_table.shape[:1])),
                "tanh_table": (tanh_table, tuple(tanh_table.shape[:1]))}
    for name, (t, want) in operands.items():
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(
                f"lstm_window_int: {name} must be int32 of shape {want}, "
                f"got {t.dtype} {tuple(t.shape)} (spec {spec})")
        if not t.is_contiguous():
            raise ValueError(f"lstm_window_int: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"lstm_window_int: {name} is on {t.device}, "
                             f"x on {x.device}")
    A, C, W = spec.act_fmt, spec.state_fmt, spec.w_fmt
    # every ROM address is an act_fmt code (gates and requant(c) are
    # saturated to A), so both tables must cover [A.lo, A.hi]
    for name, lo, depth in (("sig", spec.sig_lo, sig_table.shape[0]),
                            ("tanh", spec.tanh_lo, tanh_table.shape[0])):
        if lo > A.lo or A.hi - lo >= depth:
            raise ValueError(
                f"lstm_window_int: {name} ROM (offset {lo}, depth {depth}) "
                f"does not cover the {A} code range")
    if not 0 <= C.frac_bits - A.frac_bits < 32 or \
            not 0 <= W.frac_bits < 32 or not 0 <= A.frac_bits < 32:
        raise ValueError(f"lstm_window_int: formats A={A} W={W} C={C} need "
                         "shifts in [0, 32) and state precision >= act")


@reports("lstm_window_int", lambda x, w, *_, spec, **__: 2 * x.shape[0]
         * spec.seq_len * w.shape[0] * w.shape[1])
def lstm_window_int(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    sig_table: torch.Tensor, tanh_table: torch.Tensor,
                    *, spec: CellSpec, block_b: int = 128) -> torch.Tensor:
    """(B,S,d_in) int codes × fused int gate weights -> (B, S, hidden) int32.

    x holds ``spec.act_fmt`` codes; w holds any int32 codes. One kernel
    launch per window batch on a CUDA tensor, the one :func:`variant` names
    for this spec and this w; the plain version on a CPU tensor; the empty
    result on a ``meta`` tensor. ``block_b`` (the reference's Pallas block
    of windows) must be a positive int and is not read: each variant tiles
    the windows its own way, and the result does not depend on it.
    """
    global launches
    if isinstance(block_b, bool) or not isinstance(block_b, int) \
            or block_b < 1:
        raise ValueError(f"lstm_window_int: block_b must be a positive int, "
                         f"got {block_b!r}")
    _check(x, w, b, sig_table, tanh_table, spec)
    if x.device.type == "cpu":
        return lstm_window_int_ref(x, w, b, sig_table, tanh_table, spec=spec)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], spec.seq_len, spec.hidden),
                           dtype=torch.int32, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_window_int: no kernel for device {x.device}")
    out = torch.empty((x.shape[0], spec.seq_len, spec.hidden),
                      dtype=torch.int32, device=x.device)
    name = variant(spec, w)
    with torch.cuda.device(x.device):
        lstm_window_int_cuda(x, w, b, sig_table, tanh_table, out, spec=spec,
                             variant=name)
    launches += 1
    launches_by_variant[name] += 1
    return out
