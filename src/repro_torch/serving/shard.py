"""Splitting large serving batches over several devices (port of
``repro/serving/shard.py``).

A farm dispatch is one ``(B, L, F)`` batch through one program; with
several devices the batch axis is embarrassingly parallel — every template
is batch-row independent, the same property that makes micro-batching
bit-exact. The reference shards the batch over a 1-D JAX mesh with
``shard_map``. The port's mesh is a list of devices (every visible CUDA
device by default): :class:`ShardedExecutable` keeps one copy of the
design's emulator on each device, runs each device's slice of the batch
on its own copy (on CUDA a replay of that copy's CUDA Graph), and gathers
the slices on the first device. No collective is needed, so nothing of
``torch.distributed`` is used.

:class:`ShardedExecutable` keeps the Deployment duck type the farm needs:
callable on float windows, ``holds_program`` for router affinity, a
``trace_count`` observable, and bit-exactness — outputs are integer-
identical to the unsharded executable because every device runs the same
integer graph walk on its batch slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.quant.fixedpoint import fxp_to_int
from repro_torch.rtl.emulator import RTLEmulator, dtype_name
from repro_torch.rtl.program_cache import ProgramLRU

Device = Union[str, torch.device]


def make_serving_mesh(n_devices: Optional[int] = None
                      ) -> List[torch.device]:
    """The serving mesh: the first ``n_devices`` CUDA devices (all visible
    ones by default). Raises when the host has fewer."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise RuntimeError(f"make_serving_mesh: {n} CUDA device(s) asked "
                           f"for, {have} visible; pass a device list (e.g. "
                           "['cpu', 'cpu']) to split on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class ShardedExecutable:
    """An ``RTLExecutable`` whose dispatches split the batch over devices.

    ``__call__`` pads the batch up to a multiple of the device count,
    runs one slice per device, gathers the slices and trims the padding.
    Programs are cached per padded ``(shape, dtype)`` exactly like the
    unsharded executor, so :meth:`holds_program` keeps router affinity
    meaningful; each such program is the set of per-device programs its
    first dispatch built.
    """

    def __init__(self, exe, mesh: Optional[Sequence[Device]] = None, *,
                 max_programs: int = 8):
        self.exe = exe
        self.devices = [torch.device(d) for d in
                        (mesh if mesh is not None else make_serving_mesh())]
        if not self.devices:
            raise ValueError("ShardedExecutable needs at least one device")
        self.n_shards = len(self.devices)
        # one emulator copy per device (its own program cache); the locked
        # LRU below keys the padded batch shapes farm threads dispatch
        self.emulators = [RTLEmulator(exe.graph, mode=exe.emulator_mode,
                                      max_programs=max_programs, device=d)
                          for d in self.devices]
        self._programs = ProgramLRU(max_programs)
        self.trace_count = 0

    @property
    def emulator(self):
        return self.exe.emulator

    @property
    def graph(self):
        return self.exe.graph

    def holds_program(self, shape, dtype) -> bool:
        # programs are keyed on the padded int32 batch the dispatch actually
        # runs, not the caller's float dtype (same contract as
        # RTLExecutable.holds_program)
        b = self._padded_b(int(shape[0]))
        key = ((b,) + tuple(int(d) for d in shape[1:]), "int32")
        return key in self._programs

    def _padded_b(self, b: int) -> int:
        n = self.n_shards
        return ((b + n - 1) // n) * n

    def _program(self, shape: Tuple[int, ...], dtype):
        def build():
            self.trace_count += 1
            return self._dispatch

        prog, _hit, _evicted = self._programs.get_or_build(
            (tuple(int(d) for d in shape), dtype_name(dtype)), build)
        return prog

    def _dispatch(self, x_int: torch.Tensor) -> torch.Tensor:
        per = x_int.shape[0] // self.n_shards
        outs = [em.run_int(x_int[i * per:(i + 1) * per]).outputs
                for i, em in enumerate(self.emulators)]
        home = self.devices[0]
        return torch.cat([y.to(home) for y in outs])

    def __call__(self, x) -> torch.Tensor:
        g = self.exe.graph
        in_fmt = g.edges[g.inputs[0]].fmt
        out_fmt = g.edges[g.outputs[0]].fmt
        x = torch.as_tensor(x, device=self.devices[0])
        x_int = fxp_to_int(x, in_fmt).to(torch.int32)
        b = int(x_int.shape[0])
        pb = self._padded_b(b)
        if pb > b:                           # pad rows to a shard multiple
            filler = torch.zeros((pb - b,) + tuple(x_int.shape[1:]),
                                 dtype=x_int.dtype, device=x_int.device)
            x_int = torch.cat([x_int, filler], dim=0)
        y_int = self._program(x_int.shape, x_int.dtype)(x_int)
        return y_int[:b].to(torch.float32) / out_fmt.scale

    def run_many(self, xs):
        """List-of-batches entry matching ``RTLExecutable.run_many``."""
        if not isinstance(xs, (list, tuple)):
            return self(xs)
        xs = [torch.as_tensor(x, device=self.devices[0]) for x in xs]
        out = self(torch.cat(xs, dim=0))
        res, off = [], 0
        for x in xs:
            res.append(out[off:off + x.shape[0]])
            off += x.shape[0]
        return res
