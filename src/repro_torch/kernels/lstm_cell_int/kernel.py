"""Launcher of the CUDA fused integer LSTM-window kernels
(``csrc/lstm_cell_int.cu``), the port of
``repro/kernels/lstm_cell_int/kernel.py::lstm_window_int_pallas``.

One launch runs every timestep of one ``lstm_cell`` node for a whole batch
of windows: the gate matrix, the bias and both activation ROMs are staged in
shared memory per block, the (h, c) state stays on chip, and only the
(B, S, hidden) hidden sequence is written out. Two variants:

* ``mma`` — the gate product on the int8 tensor cores (``mma.sync``
  m16n8k32, int32 sums), 16 windows a warp; for cells whose x, h and W
  codes fit int8 (:func:`mma_takes`);
* ``simt`` — one thread a window in int32 CUDA-core arithmetic, exact for
  any codes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build
from repro_torch.quant.fixedpoint import FxpFormat


@dataclass(frozen=True)
class CellSpec:
    """Static metadata of one lstm_cell node: the window geometry, the
    three Q-formats' requant parameters, and the LUT address offsets (ROM
    tables are indexed by ``code - lo``, offset-binary order)."""

    seq_len: int
    d_in: int
    hidden: int
    act_fmt: FxpFormat               # A: x, h, gate post-LUT values
    state_fmt: FxpFormat             # C: cell state
    w_fmt: FxpFormat                 # W: gate matrix codes
    sig_lo: int                      # sigmoid ROM address offset
    tanh_lo: int                     # tanh ROM address offset


#: the kernels of ``csrc/lstm_cell_int.cu``, by the number its C entry
#: point takes
VARIANTS = {"simt": 0, "mma": 1}
#: the ``mma`` kernel's tiles: K = d_in + hidden in at most four k32 steps,
#: 4 * hidden gate columns in at most 32 n8 tiles
MMA_MAX_K = 128
MMA_MAX_HIDDEN = 64


def mma_takes(spec: CellSpec) -> bool:
    """Whether the ``mma`` kernel computes this cell exactly.

    Its exactness envelope: x and h are ``act_fmt`` codes and W ``w_fmt``
    codes, each at most 8 bits, so every product is an int8 x int8 one;
    with K = d_in + hidden <= :data:`MMA_MAX_K` the int32 sum is bounded by
    K * 2^7 * 2^7 <= 2^21 < 2^31, so no accumulator can wrap and the sum
    is the exact one the plain version's int32 loop gives. The hidden
    width must fit its 32 n8 tiles.
    """
    return (spec.act_fmt.total_bits <= 8 and spec.w_fmt.total_bits <= 8
            and spec.d_in + spec.hidden <= MMA_MAX_K
            and spec.hidden <= MMA_MAX_HIDDEN)


#: each W tensor whose codes were read, by identity: its version counter
#: then and its least and largest code
_w_range = WeakIdKeyDictionary()


def check_w_codes(w: torch.Tensor, spec: CellSpec) -> bool:
    """Whether ``w`` holds ``spec.w_fmt`` codes, as the ``mma`` kernel's
    int8 fragments need. Reading the range back syncs the stream, so it is
    read once per version of a tensor (an in-place write, such as an SEU
    model's flipped bit, bumps the version): the emulator passes the same
    prepared W to every call, and checks it outside any capture."""
    seen = _w_range.get(w)
    if seen is None or seen[0] != w._version:
        lo, hi = torch.aminmax(w)
        seen = _w_range[w] = (w._version, int(lo), int(hi))
    return spec.w_fmt.lo <= seen[1] and seen[2] <= spec.w_fmt.hi


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell_int")
    lib.lstm_cell_int_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 15
        + [ctypes.c_void_p])
    lib.lstm_cell_int_launch.restype = ctypes.c_int
    return lib


def lstm_window_int_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         sig_table: torch.Tensor, tanh_table: torch.Tensor,
                         out: torch.Tensor, *, spec: CellSpec,
                         variant: str) -> None:
    """Launch the named variant on the current stream of ``x``'s device;
    checked operands (int32, contiguous, one device) come from the wrapper.
    ``mma`` takes only a cell :func:`mma_takes`, a ``w`` of ``w_fmt``
    codes (:func:`check_w_codes`; another is a ValueError) and an ``out``
    whose base is 16-byte aligned (it stores 16 bytes at a time); ``simt``
    takes any.
    """
    if variant not in VARIANTS:
        raise ValueError(f"lstm_window_int_cuda: unknown variant "
                         f"{variant!r}; one of {sorted(VARIANTS)}")
    if variant == "mma":
        if not mma_takes(spec):
            raise ValueError(f"lstm_window_int_cuda: the mma kernel does not "
                             f"take {spec}: its codes must fit int8, K <= "
                             f"{MMA_MAX_K} and hidden <= {MMA_MAX_HIDDEN}")
        if out.data_ptr() % 16:
            raise ValueError("lstm_window_int_cuda: mma needs a "
                             "16-byte-aligned out")
        if not check_w_codes(w, spec):
            _, lo, hi = _w_range[w]
            fmt = spec.w_fmt
            raise ValueError(
                f"lstm_window_int_cuda: w codes span [{lo}, {hi}], outside "
                f"{fmt}'s [{fmt.lo}, {fmt.hi}]: launch simt")
    lib = _lib()
    A, C = spec.act_fmt, spec.state_fmt
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_int_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), sig_table.data_ptr(),
        tanh_table.data_ptr(), out.data_ptr(), x.shape[0], spec.seq_len,
        spec.d_in, spec.hidden, spec.w_fmt.frac_bits, A.frac_bits,
        C.frac_bits, A.lo, A.hi, C.lo, C.hi, spec.sig_lo, spec.tanh_lo,
        sig_table.shape[0], tanh_table.shape[0], VARIANTS[variant], stream)
    build.check(lib, err, "lstm_cell_int launch")
