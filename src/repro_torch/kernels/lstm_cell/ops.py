"""Public wrapper of the float LSTM-window template (B3)."""
from __future__ import annotations

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.lstm_cell.kernel import lstm_window_cuda, mma_takes
from repro_torch.kernels.lstm_cell.ref import lstm_window_ref

#: kernel launches made by :func:`lstm_window` (CPU calls do not count)
launches = 0
#: ... and by the variant :func:`variant` chose
launches_by_variant = {"mma": 0, "simt": 0}


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call with these operands launches, decided from
    their shapes alone: ``"mma"`` (the gate product in split TF32 on the
    tensor cores) for hidden <= 64 and d_in + hidden <= 128 (Table I, the
    reference test's shapes), ``"simt"`` (f32 FMAs on the CUDA cores) for
    the rest."""
    return "mma" if mma_takes(x.shape[2], w.shape[1] // 4) else "simt"


def _check(x, w, b, block_b: int) -> None:
    if x.ndim != 3 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(f"lstm_window: x must be (B, S, d_in), w (d_in+H, "
                         f"4H), b (4H,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    d_in, G = x.shape[2], w.shape[1]
    if G % 4 or G == 0 or w.shape[0] != d_in + G // 4 or b.shape[0] != G:
        raise ValueError(f"lstm_window: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not fit d_in={d_in}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise ValueError(f"lstm_window: {name} is {t.dtype}; the "
                             "template is float32")
        if t.device != x.device:
            raise ValueError(f"lstm_window: {name} is on {t.device}, x on "
                             f"{x.device}")
    if block_b < 1:
        raise ValueError(f"lstm_window: block_b must be >= 1, got {block_b}")


@reports("lstm_window", lambda x, w, b, **_: 2 * x.shape[0] * x.shape[1]
         * w.shape[0] * w.shape[1])
def lstm_window(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                block_b: int = 128) -> torch.Tensor:
    """(B, S, d_in) × fused gate weights -> final hidden (B, hidden).

    On a CUDA tensor one kernel launch runs every step for every window,
    the one :func:`variant` names: ``simt`` takes ``block_b`` windows to a
    block (fewer if shared memory is short), ``mma`` its fixed tiles of 16
    windows and ignores ``block_b``; the result does not depend on it, and
    the ragged last tile is masked, not padded. On a CPU tensor the plain
    version runs; on a ``meta`` tensor the empty result comes back.
    """
    global launches
    _check(x, w, b, block_b)
    if x.device.type == "cpu":
        return lstm_window_ref(x, w, b)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], w.shape[1] // 4), dtype=x.dtype,
                           device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_window: no kernel for device {x.device}")
    out = torch.empty((x.shape[0], w.shape[1] // 4), dtype=x.dtype,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    name = variant(x, w)
    with torch.cuda.device(x.device):
        lstm_window_cuda(x.contiguous(), w.contiguous(), b.contiguous(), out,
                         block_b=block_b, variant=name)
    launches += 1
    launches_by_variant[name] += 1
    return out
