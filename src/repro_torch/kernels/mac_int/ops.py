"""Public wrapper of the integer MAC template (B2)."""
from __future__ import annotations

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.mac_int.kernel import mac_int_cuda
from repro_torch.kernels.mac_int.ref import mac_int_ref

#: kernel launches made by :func:`mac_int_op` (CPU calls do not count)
launches = 0

_INT32_LO, _INT32_HI = -(2 ** 31), 2 ** 31 - 1


def _check(xh, w, b, shift, lo, hi) -> None:
    for name, t, ndim in (("xh", xh, 2), ("w", w, 2), ("b", b, 1)):
        if t.dtype != torch.int32 or t.ndim != ndim:
            raise ValueError(f"mac_int: {name} must be {ndim}-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"mac_int: {name} must be contiguous")
        if t.device != xh.device:
            raise ValueError(f"mac_int: {name} is on {t.device}, xh on "
                             f"{xh.device}")
    if xh.shape[1] != w.shape[0] or b.shape[0] != w.shape[1]:
        raise ValueError(f"mac_int: shapes xh {tuple(xh.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not chain")
    if not -31 <= shift <= 31:
        raise ValueError(f"mac_int: shift {shift} outside [-31, 31]")
    if not _INT32_LO <= lo <= hi <= _INT32_HI:
        raise ValueError(f"mac_int: bad clip range [{lo}, {hi}]")


@reports("mac_int", lambda xh, w, b, **_: 2 * xh.shape[0] * xh.shape[1]
         * w.shape[1])
def mac_int_op(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               shift: int, lo: int, hi: int) -> torch.Tensor:
    """(B, K) int32 @ (K, N) int32 + b, requantized by ``shift`` and clipped
    to [lo, hi]: one template invocation, (B, N) int32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version; on a ``meta`` tensor it returns the empty result.
    """
    global launches
    _check(xh, w, b, shift, lo, hi)
    if xh.device.type == "cpu":
        return mac_int_ref(xh, w, b, shift=shift, lo=lo, hi=hi)
    if xh.device.type == "meta":
        return torch.empty((xh.shape[0], w.shape[1]), dtype=torch.int32,
                           device=xh.device)
    if xh.device.type != "cuda":
        raise ValueError(f"mac_int: no kernel for device {xh.device}")
    out = torch.empty((xh.shape[0], w.shape[1]), dtype=torch.int32,
                      device=xh.device)
    with torch.cuda.device(xh.device):
        mac_int_cuda(xh, w, b, out, shift=shift, lo=lo, hi=hi)
    launches += 1
    return out
