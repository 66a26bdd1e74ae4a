"""A graph walk captured as one CUDA Graph: the port's compiled program.

The reference jits the emulator's graph walk once per ``(shape, dtype)``
and replays the compiled program. The torch counterpart is a
``torch.cuda.CUDAGraph`` of the eager walk, captured once per key of the
emulator's :class:`~repro_torch.rtl.program_cache.ProgramLRU` and replayed
on every later call: one replay launches the walk's every kernel (B1, B2
and the glue) with no Python in between.

:class:`CapturedProgram` keeps these rules:

* It owns static buffers: the input, the params (the program's operands,
  per-node dicts of int32 tensors) and the walk's output env. A call copies
  its input in, copies the caller's params in unless the buffers already
  hold them (which is what lets an isomorphic sibling's emulator replay a
  program built through another), replays, and clones the env out, so a
  caller keeps its result after the next call.
* One eager run of the walk on those buffers comes before the capture, so
  the first ``nvcc`` build, the module load and ``cudaFuncSetAttribute``
  happen outside it, and every host-side check a wrapper caches per tensor
  (B1's ``check_w_codes``, which syncs) is cached on the very buffers the
  capture reads. That run's result answers the call that built the
  program.
* A kernel wrapper counts a launch where it launches; a capture records
  launches without running them. So the counts the capture added are taken
  back, and each replay adds them again: the counters go on counting kernel
  work that ran.
* A capture that fails raises. Nothing falls back to the eager walk.
* The graph and its memory pool live as long as this object: the LRU entry
  that holds it. Eviction and ``ProgramLRU.clear`` free them.
"""
from __future__ import annotations

import functools
import importlib
import sys
import threading
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]
Env = Dict[str, torch.Tensor]
#: (ops module name, variant or None) -> launches
Launches = Dict[Tuple[str, Optional[str]], int]


@functools.lru_cache(maxsize=None)
def _ops_modules() -> Tuple[str, ...]:
    from repro_torch.kernels import TEMPLATES

    return tuple(importlib.import_module(f"repro_torch.kernels.{name}.ops")
                 .__name__ for name in TEMPLATES)


def read_launches() -> Launches:
    """Every kernel wrapper's launch counters (``ops.launches`` and, where
    a wrapper has variants, ``ops.launches_by_variant``), read now."""
    out: Launches = {}
    for name in _ops_modules():
        mod = sys.modules[name]
        out[(name, None)] = mod.launches
        for variant, n in getattr(mod, "launches_by_variant", {}).items():
            out[(name, variant)] = n
    return out


def add_launches(delta: Launches) -> None:
    """Add ``delta`` to the wrappers' counters (read afresh: callers may
    rebind ``launches_by_variant`` to a new dict)."""
    for (name, variant), n in delta.items():
        mod = sys.modules[name]
        if variant is None:
            mod.launches += n
        else:
            mod.launches_by_variant[variant] += n


def _clone_params(params: Params) -> Params:
    return {name: {k: v.clone() for k, v in arrays.items()}
            for name, arrays in params.items()}


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class CapturedProgram:
    """One CUDA Graph of a graph walk on static buffers.

    ``make_walk(static_params)`` returns the walk, ``walk(static_x) ->
    env``; it is built once, after the buffers exist, so any view it takes
    of the params (the multi-design emulator's per-design slices) is one
    object for the warm-up and the capture. ``x`` and ``params`` are the
    building call's operands, on one CUDA device; ``token`` names whose
    params they are, at which versions (see :meth:`__call__`).
    """

    def __init__(self, make_walk: Callable[[Params], Callable[[torch.Tensor],
                                                              Env]],
                 x: torch.Tensor, params: Params, token: Hashable):
        if x.device.type != "cuda":
            raise ValueError(f"CapturedProgram: x is on {x.device}; a CUDA "
                             "Graph needs a CUDA tensor")
        self.device = x.device
        self._lock = threading.Lock()
        with torch.cuda.device(self.device):
            self.static_x = x.clone()
            self.static_params = _clone_params(params)
            self.loaded = token
            walk = make_walk(self.static_params)
            warm = walk(self.static_x)           # eager, outside the capture
            # the answer of the building call: entries that alias the input
            # buffer are copied, the rest are the warm-up's own tensors
            self.first: Optional[Env] = {
                k: v.clone() if _shares_storage(v, self.static_x) else v
                for k, v in warm.items()}
            del warm
            before = read_launches()
            self.graph = torch.cuda.CUDAGraph()
            # captured on a side stream, as torch.cuda.graph does, but
            # without its torch.cuda.empty_cache(): a process builds
            # programs again and again, and flushing the caching allocator
            # at each would turn later allocations into cudaMalloc calls
            # The side stream is this capture's own: other threads queue
            # their work on their own current streams, never on it. The
            # capture checks only this thread's CUDA calls
            # ("thread_local"): the default ("global") also fails it when
            # another thread syncs meanwhile (a runner reading its answer
            # with torch.equal while a flip's next run captures again).
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.env: Env = walk(self.static_x)
                finally:
                    self.graph.capture_end()
            current.wait_stream(side)
            after = read_launches()
        self.launches: Launches = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})

    def take_first(self) -> Env:
        """The warm-up run's env (once; the building call's result)."""
        env, self.first = self.first, None
        if env is None:
            raise RuntimeError("CapturedProgram: the first result was "
                               "already taken")
        return env

    def __call__(self, x: torch.Tensor, params: Params,
                 token: Hashable) -> Env:
        """Replay on ``x`` with ``params``: the param buffers are rewritten
        only when they hold params of another ``token``."""
        with self._lock, torch.cuda.device(self.device):
            self.static_x.copy_(x)
            if self.loaded != token:
                for name, arrays in params.items():
                    dst = self.static_params[name]
                    for k, v in arrays.items():
                        dst[k].copy_(v)
                self.loaded = token
            self.graph.replay()
            add_launches(self.launches)
            return {k: v.clone() for k, v in self.env.items()}
