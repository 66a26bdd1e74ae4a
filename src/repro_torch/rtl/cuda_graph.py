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
* The graph and its private memory pool live as long as this object: the
  LRU entry that holds it, or a replay under way. Once it is gone
  (evicted, ``ProgramLRU.clear``, an emulator's ``flip_bit``, its
  emulator collected) the pool's blocks are free but stay reserved by
  PyTorch's caching allocator, and an allocation during a capture cannot
  return them to the device. So every capture takes one process-wide lock
  (:func:`capturing`), and the first capture after a program was dropped
  calls ``torch.cuda.empty_cache()`` under it, before its
  ``capture_begin``: then no capture is under way in any thread. A
  capture does not empty the cache otherwise, since that would turn later
  allocations into ``cudaMalloc`` calls.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import threading
import weakref
from typing import Callable, Dict, Hashable, Iterator, Optional, Tuple

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


# Every capture of this module holds this lock from its cache release to
# its capture_end. _DROPPED gets one entry a dropped program, by an append
# (atomic, and lock-free: a finalizer may run from the garbage collector in
# a thread that holds the lock); a release takes the entries it saw.
_CAPTURE_LOCK = threading.Lock()
_DROPPED: list = []


class _Pool:
    """What a capture allocated from its private pool: the graph and the
    walk's output env."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.env: Env = {}

    def free(self) -> None:
        self.env, self.graph = {}, None


def _dropped(pool: Optional[_Pool]) -> None:
    if pool is not None:
        pool.free()             # the graph and its outputs go first
    _DROPPED.append(None)


def track(program, pool: Optional[_Pool] = None) -> None:
    """Count ``program`` as dropped once it is collected, after freeing
    ``pool``, so that the next capture returns the pool's memory."""
    weakref.finalize(program, _dropped, pool)


@contextlib.contextmanager
def capturing() -> Iterator[None]:
    """Hold the process-wide capture lock; on entry, if a program was
    dropped since the last release, return the caching allocator's free
    blocks (the dropped pools among them) with one
    ``torch.cuda.empty_cache()``. Enter it around ``capture_begin`` ...
    ``capture_end``."""
    with _CAPTURE_LOCK:
        n = len(_DROPPED)
        if n:
            del _DROPPED[:n]
            torch.cuda.empty_cache()
        yield


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
            self._pool = _Pool()
            track(self, self._pool)
            self._pool.graph = torch.cuda.CUDAGraph()
            # captured on a side stream, as torch.cuda.graph does, but
            # without its torch.cuda.empty_cache() at every capture (see
            # capturing: the cache is emptied only after a program was
            # dropped). The side stream is this capture's own: other
            # threads queue their work on their own current streams, never
            # on it. The capture checks only this thread's CUDA calls
            # ("thread_local"): the default ("global") also fails it when
            # another thread syncs meanwhile (a runner reading its answer
            # with torch.equal while a flip's next run captures again).
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with capturing(), torch.cuda.stream(side):
                self._pool.graph.capture_begin(
                    capture_error_mode="thread_local")
                try:
                    self._pool.env = walk(self.static_x)
                finally:
                    self._pool.graph.capture_end()
            current.wait_stream(side)
            after = read_launches()
        self.launches: Launches = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})

    @property
    def graph(self) -> torch.cuda.CUDAGraph:
        return self._pool.graph

    @property
    def env(self) -> Env:
        return self._pool.env

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
