"""What one step of a torch program costs: the port's counterpart of a
compiled module's ``cost_analysis()``, ``memory_analysis()`` and
``as_text()``, which the host target's report reads.

:func:`count_step` runs ``fn(*args)`` once under one
``TorchDispatchMode`` and counts every aten op it issues. It runs on any
device; on ``meta`` tensors nothing executes, so a full-width model is
counted without its weights (the reference's abstract lowering).

* FLOPs. The matmul family (``mm``, ``bmm``, ``addmm``, ``mv``,
  ``_int_mm``, ``convolution``, ...) counts 2·M·N·K a product (a
  convolution 2 · output elements · its contraction). A reduction counts
  one FLOP per element it reads, as XLA's HLO cost analysis charges its
  reducer once per element reduced; every other op that computes (each
  elementwise op, a dtype conversion, any op not named below) counts one
  FLOP per output element, the rule XLA's cost analysis uses for
  elementwise ops. Ops that only move data (copies, concatenations,
  fills, gathers and scatters) count none, as XLA counts none for copy,
  concatenate, broadcast, gather or scatter.
* Bytes accessed: for each op, the bytes of its tensor inputs plus its
  outputs: the traffic of the eager program, each op reading its operands
  from memory and writing its results back. Views and metadata ops
  (``view``, ``transpose``, ``expand``, ``slice``, ``detach``, ``empty``,
  ...) count 0. A gather reads what it gathers (its output's bytes) and its
  indices, not the whole table; a write into part of a tensor
  (``index_put_``, ``copy_``, ``fill_``, ``scatter_``, ...) reads its
  values and writes as many, not the whole destination.
* ``argument_bytes`` and ``output_bytes``: the storages the step's inputs
  and results hold (a view holds its whole base); ``alias_bytes`` the
  results' storages that are inputs' (a cache updated in place).
* ``temp_bytes``: the peak of the live bytes of the intermediates, the
  storages the step creates and its results do not hold: a storage is
  added when the op that creates it returns and taken off once it is
  freed.
* ``ops``: one :class:`OpCost` a counted op (name, input and output shapes
  and dtypes, FLOPs, bytes, meter channel); :meth:`StepCost.as_text` is
  the op list, which replaces ``module.hlo.txt``.
* ``work`` and ``op_counts``: per meter channel
  (:func:`repro_torch.energy.meter.aten_channel`): ``mxu`` FLOPs of
  products, ``vpu`` and ``reduce`` their FLOPs, ``gather``, ``layout`` and
  ``other`` their ops' bytes, ``hbm`` all bytes accessed, ``ici`` the
  bytes of the collectives (0 on one card).
* Collectives (the ``c10d`` and ``_c10d_functional`` ops a step on a
  device mesh issues) count no FLOPs, as XLA's cost analysis counts none
  for a collective's transfer; their bytes are their operands read and
  their results written, on the ``ici`` channel. A functional
  collective's wrappers (``wait_tensor``, ``_wrap_tensor_autograd``)
  count nothing. The bytes on the wire are not counted here: the dry-run
  (``launch/dryrun.py``) reckons them.

The hand-written kernels are counted as what they compute: a kernel
launched through ``ctypes`` is invisible to any dispatch mode, so each
public wrapper reports one op with the analytic FLOPs of its function and
the bytes of its inputs and outputs (``repro_torch.kernels.reports``), and
the aten ops issued inside it are not counted. A step therefore counts the
same on the CPU (where the wrapper runs its plain version), on ``meta`` and
on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.energy.meter import CHANNEL_WATTS, aten_channel

#: dtype names as HLO writes them
_DTYPE_NAMES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

#: ops that create or describe a tensor without computing or moving data
_METADATA = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "detach_", "alias",
             "lift_fresh", "_unsafe_view", "resize_", "set_",
             "_local_scalar_dense"}
#: ops that write their first argument where the values land: the bytes
#: are the values read and as many written, not the whole destination
_SLICE_WRITES = {"copy_", "fill_", "zero_"}            # all of a view
_INDEX_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                 "scatter_", "scatter_add_", "index_add_",
                 "masked_scatter_"}                     # the values' size
#: ops that read only the elements they gather (and their indices)
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
#: the namespaces of the collectives: ``torch.distributed``'s in-place
#: ops and the functional ones ``DTensor`` issues
COLLECTIVES = {"c10d", "_c10d_functional"}
#: a functional collective's wrappers, which move nothing
COLLECTIVE_WRAPPERS = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


def _shape(t: torch.Tensor) -> str:
    dtype = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dtype}[{','.join(str(d) for d in t.shape)}]"


@dataclass
class OpCost:
    """One counted op of a step."""

    name: str
    inputs: str
    outputs: str
    flops: float
    bytes: float
    channel: str

    def line(self) -> str:
        return (f"{self.name} ({self.inputs}) -> ({self.outputs}) "
                f"flops {self.flops:.0f} bytes {self.bytes:.0f} "
                f"channel {self.channel}")


@dataclass
class StepCost:
    """The counts of one step; see the module docstring."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    ops: List[OpCost] = field(default_factory=list)
    work: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(CHANNEL_WATTS, 0.0))
    op_counts: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(CHANNEL_WATTS, 0))

    def cost_analysis(self) -> Dict[str, float]:
        """The keys of ``compiled.cost_analysis()`` that the roofline
        reads."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}

    def as_text(self) -> str:
        """The op list, one line an op (``module.ops.txt``)."""
        return "".join(op.line() + "\n" for op in self.ops)

    def add(self, op: OpCost) -> None:
        self.ops.append(op)
        self.flops += op.flops
        self.bytes_accessed += op.bytes
        self.work["hbm"] += op.bytes
        self.work[op.channel] += (op.flops if op.channel in
                                  ("mxu", "vpu", "reduce") else op.bytes)
        self.op_counts[op.channel] += 1


def _matmul_flops(name: str, ins: List[torch.Tensor],
                  out: torch.Tensor) -> float:
    """2·M·N·K a product: 2 · output elements · contraction
    (``addmm``/``baddbmm``/``addmv`` add their output's elements for the
    sum with their first operand)."""
    if name == "convolution":
        w = ins[1]              # (C_out, C_in / groups, *kernel)
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    if name in ("addmm", "baddbmm", "addmv"):
        return 2.0 * out.numel() * ins[1].shape[-1] + out.numel()
    return 2.0 * out.numel() * ins[0].shape[-1]


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`count_step`; while it is installed
    it is also the ``repro_torch.kernels.recorder`` the wrappers report
    to."""

    def __init__(self, args):
        super().__init__()
        self.cost = StepCost()
        self.quiet = 0                     # > 0 inside a kernel wrapper
        self.args = {StorageWeakRef(t.untyped_storage()).cdata
                     for t in _tensors(args)}
        # a storage's address may be reused once it is freed, so each one
        # tracked gets an id of its own: address -> (id, weak ref, bytes)
        self.live: Dict[int, tuple] = {}
        self.events: List[tuple] = []      # (id, +bytes or -bytes)

    def _sweep(self) -> None:
        """Take the storages freed since the last op off the live set."""
        for key, (uid, ref, nb) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.events.append((uid, -nb))

    def _track(self, outs: List[torch.Tensor]) -> None:
        """Add the storages an op created to the live set."""
        for t in outs:
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata in self.args or ref.cdata in self.live:
                continue
            nb = _storage_bytes(t)
            self.live[ref.cdata] = (len(self.events), ref, nb)
            self.events.append((len(self.events), nb))

    def kernel(self, name: str, flops: float, fn, args, kwargs):
        """One wrapper call, counted as one op; the aten ops inside it go
        uncounted."""
        ins = _tensors(list(args) + list(kwargs.values()))
        self._sweep()
        self.quiet += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.quiet -= 1
        outs = _tensors(out)
        self.cost.add(OpCost(
            name=name, inputs=", ".join(map(_shape, ins)),
            outputs=", ".join(map(_shape, outs)), flops=flops,
            bytes=float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))),
            channel="mxu"))
        self._track(outs)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # an op that is a composition (``matmul``, ``linear``, ...)
            # reaches the mode whole where autograd is off: count its parts,
            # as they run with autograd on
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        self._sweep()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        collective = func.namespace in COLLECTIVES
        if (func.is_view or name in _METADATA
                or (collective and name in COLLECTIVE_WRAPPERS)):
            self._track(outs)              # an allocation holds memory
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        channel = ("ici" if collective else
                   aten_channel(name, torch.Tag.pointwise in func.tags))
        out_bytes = sum(map(_nbytes, outs))
        if name in _SLICE_WRITES:
            nbytes = sum(map(_nbytes, ins[1:])) + out_bytes
        elif name in _INDEX_WRITES:
            nbytes = sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
        elif name in _GATHERS:
            nbytes = sum(_nbytes(t) for t in ins[1:]
                         if not t.is_floating_point()) + 2 * out_bytes
        else:
            nbytes = sum(map(_nbytes, ins)) + out_bytes
        if channel == "mxu":
            flops = _matmul_flops(name, ins, outs[0])
        elif channel == "reduce":
            flops = float(ins[0].numel())
        elif channel in ("gather", "layout", "ici"):
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        self.cost.add(OpCost(
            name=str(func), inputs=", ".join(map(_shape, ins)),
            outputs=", ".join(map(_shape, outs)), flops=flops,
            bytes=float(nbytes), channel=channel))
        self._track(outs)
        return out


def _storages(tree) -> Dict[int, int]:
    """Address -> bytes of the distinct storages a tree's tensors hold."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        out.setdefault(StorageWeakRef(t.untyped_storage()).cdata,
                       _storage_bytes(t))
    return out


def count_step(fn, args) -> StepCost:
    """Run ``fn(*args)`` once and count it (see the module docstring).

    The call runs as the caller set it up: wrap it in
    ``torch.inference_mode()`` for a step that is served so. Returns the
    :class:`StepCost`; ``fn``'s result is dropped.
    """
    from repro_torch import kernels

    counter = _Counter(args)
    prev = kernels.recorder
    kernels.recorder = counter
    try:
        with counter:
            out = fn(*args)
    finally:
        kernels.recorder = prev
    counter._sweep()
    cost = counter.cost
    arg_storages, out_storages = _storages(args), _storages(out)
    cost.argument_bytes = sum(arg_storages.values())
    cost.output_bytes = sum(out_storages.values())
    cost.alias_bytes = sum(nb for key, nb in out_storages.items()
                           if key in arg_storages)
    held = {counter.live[key][0] for key in out_storages
            if key in counter.live}
    live = peak = 0
    for uid, nb in counter.events:
        if uid not in held:
            live += nb
            peak = max(peak, live)
    cost.temp_bytes = peak
    return cost
