"""Batched multi-design emulation — K designs in one dispatch (port of
``repro/rtl/multi.py``, DESIGN.md §15).

Design-space search evaluates K candidate accelerators that differ only in
their trained values: same node kinds, shapes, LUT sizes and Q-formats,
different weights. Such candidates are *program-isomorphic*
(:func:`repro_torch.rtl.ir.iso_key`): the staged graph walk is one program
taking the array constants as operands, so the whole candidate set can be
emulated as ONE dispatch over params stacked along a leading design axis.

What runs. The reference ``jax.vmap``s its pure-``jnp`` walk over the
design axis. The port's program on CUDA is **one CUDA Graph holding the K
designs' ``fused`` walks**
(:class:`~repro_torch.rtl.cuda_graph.CapturedProgram`): walk k reads its
own slice of the stacked params and its results are stacked into a
``(K, B, ...)`` output, so one replay is one dispatch for all K designs
and launches B1 and B2 K times each. On the CPU a program is the same K
walks, which run the kernels' plain versions. Either way every design's
result equals its own ``fused`` emulator's integer for integer, and so, by
the §4 contract, its ``jnp`` and ``pallas`` results. The reports keep the
reference's label ``"vmap-jnp"`` for this path
(:func:`repro_torch.verify.conformance.run_conformance_batch`), so their
JSON equals the reference's.

``shard=True`` splits the design axis over a list of devices (every
visible CUDA device by default; :func:`repro_torch.serving.shard.
make_serving_mesh`) when there are several and they divide K: each device
runs its share of the designs in a program of its own, and the results
are gathered on the emulator's device. Candidates are independent, so the
split is embarrassing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs import get_metrics, get_tracer
from repro_torch.quant.fixedpoint import fxp_to_int
from repro_torch.rtl.emulator import (_CANONICAL, EagerProgram,
                                      EmulationResult, RTLEmulator,
                                      dtype_name)
from repro_torch.rtl.ir import Graph, iso_key
from repro_torch.rtl.program_cache import ProgramLRU

Device = Optional[Union[str, torch.device]]
Params = Dict[str, Dict[str, torch.Tensor]]


def assert_isomorphic(graphs: Sequence[Graph]) -> str:
    """The shared iso key of ``graphs``; raises listing every mismatch."""
    if not graphs:
        raise ValueError("need at least one graph")
    keys = [iso_key(g) for g in graphs]
    bad = [(i, graphs[i].name, k)
           for i, k in enumerate(keys) if k != keys[0]]
    if bad:
        lines = ", ".join(f"#{i} {name!r} ({k})" for i, name, k in bad)
        raise ValueError(
            f"graphs are not program-isomorphic to #0 "
            f"{graphs[0].name!r} ({keys[0]}): {lines} — same node "
            "kinds/shapes/LUT sizes and Q-formats are required; only "
            "weight/bias values may differ")
    return keys[0]


def stack_params(emulators: Sequence[RTLEmulator]) -> Params:
    """Stack K isomorphic emulators' params along a new leading design
    axis (the axis the shared program runs its walks over)."""
    per = [em.params() for em in emulators]
    return {name: {k: torch.stack([p[name][k] for p in per])
                   for k in arrays}
            for name, arrays in per[0].items()}


def _design_slice(params: Params, sl: slice, device: torch.device
                  ) -> Params:
    return {name: {k: v[sl].to(device) for k, v in arrays.items()}
            for name, arrays in params.items()}


class _ShardedProgram:
    """The design axis split over ``devices``: one program per device for
    its contiguous share of the designs, results gathered on ``home``."""

    def __init__(self, multi: "MultiDesignEmulator", x: torch.Tensor,
                 params: Params, per_design: bool):
        self.devices = multi.mesh
        self.per_design = per_design
        self.home = x.device
        self.m = multi.k // len(self.devices)
        self._loaded = (None, None)
        token = multi._token()
        parts = self._parts(x, params, token)
        self.programs, firsts = [], []
        for x_d, p_d in parts:
            prog, first = multi._build_one(x_d, p_d, per_design, token)
            self.programs.append(prog)
            firsts.append(first if first is not None
                          else prog(x_d, p_d, token))
        self.first = self._gather(firsts)

    def _parts(self, x, params, token):
        """Each device's stimulus and param share (the shares are moved
        once per owner of the params)."""
        if self._loaded[0] != token:
            self._loaded = (token, [
                _design_slice(params, slice(i * self.m, (i + 1) * self.m),
                              dev) for i, dev in enumerate(self.devices)])
        out = []
        for i, dev in enumerate(self.devices):
            x_d = x[i * self.m:(i + 1) * self.m] if self.per_design else x
            out.append((x_d.to(dev), self._loaded[1][i]))
        return out

    def _gather(self, envs: List[Dict]) -> Dict:
        return {e: torch.cat([env[e].to(self.home) for env in envs])
                for e in envs[0]}

    def __call__(self, x, params, token) -> Dict:
        parts = self._parts(x, params, token)
        return self._gather([prog(x_d, p_d, token) for prog, (x_d, p_d)
                             in zip(self.programs, parts)])


class MultiDesignEmulator:
    """K isomorphic candidate designs behind one compiled program.

    Construction validates isomorphism, stages every candidate's constants
    (one :class:`RTLEmulator` per design, all sharing one
    :class:`ProgramLRU` — so even their *single*-design dispatches build
    once), and stacks the params. :meth:`run_int` then emulates all K
    designs in one dispatch:

    * ``per_design=False`` (default) — one shared stimulus ``(B, ...)``
      for every design (the conformance-sweep shape);
    * ``per_design=True`` — stacked stimulus ``(K, B, ...)``, row k to
      design k.

    Outputs carry a leading design axis: ``result.outputs[k]`` is
    bit-identical to ``self.emulators[k].run_int(x).outputs`` (and, by the
    §4 contract, to the ``jnp``/``pallas`` paths of a per-design emulator
    — the acceptance check of DESIGN.md §15).
    """

    def __init__(self, graphs: Sequence[Graph], *, max_programs: int = 4,
                 shard: bool = False,
                 programs: Optional[ProgramLRU] = None,
                 device: Device = None,
                 devices: Optional[Sequence[Device]] = None):
        self.graphs: List[Graph] = list(graphs)
        self.iso_key = assert_isomorphic(self.graphs)
        self.k = len(self.graphs)
        self.programs = programs if programs is not None \
            else ProgramLRU(max_programs)
        self.emulators = [RTLEmulator(g, mode="fused", programs=self.programs,
                                      device=device) for g in self.graphs]
        self._base = self.emulators[0]
        self.device = self._base.device
        self._params = stack_params(self.emulators)
        self._params_token = object()
        self.mesh = self._design_mesh(devices) if shard else None
        self.sharded = self.mesh is not None
        self.trace_count = 0

    def _design_mesh(self, devices) -> Optional[List[torch.device]]:
        """The devices the design axis splits over, when there are several
        and they divide K; None (one program) otherwise."""
        if devices is None:
            if self.device.type != "cuda":
                return None
            from repro_torch.serving.shard import make_serving_mesh

            devices = make_serving_mesh()
        devices = [torch.device(d) for d in devices]
        if len(devices) <= 1 or self.k % len(devices) != 0:
            return None
        return devices

    # -- the shared program -------------------------------------------------
    def _walk(self, params: Params, per_design: bool):
        """The K designs' ``fused`` walks over ``params`` (stacked along the
        design axis): ``walk(x) -> env`` of ``(K, B, ...)`` tensors. The
        per-design views are taken once here, so a capture and its warm-up
        read the same objects."""
        k = next(iter(next(iter(params.values())).values())).shape[0]
        views = [{name: {key: v[i] for key, v in arrays.items()}
                  for name, arrays in params.items()} for i in range(k)]
        base = self._base

        def walk(x):
            envs = [base._execute(x[i] if per_design else x, "fused", p)
                    for i, p in enumerate(views)]
            return {e: torch.stack([env[e] for env in envs])
                    for e in envs[0]}

        return walk

    def _token(self):
        """Names the stacked params and their tensors' versions (see
        :meth:`RTLEmulator._operands`)."""
        return (self._params_token,
                tuple(t._version for arrays in self._params.values()
                      for t in arrays.values()))

    def _build_one(self, x: torch.Tensor, params: Params, per_design: bool,
                   token):
        """``(program, first env)`` on ``x``'s device: a CUDA Graph of the
        K walks and its warm-up's env, or the eager walks and None."""
        if x.device.type != "cuda":
            return EagerProgram(
                lambda xx, pp: self._walk(pp, per_design)(xx)), None
        from repro_torch.rtl.cuda_graph import CapturedProgram

        prog = CapturedProgram(lambda p: self._walk(p, per_design), x,
                               params, token)
        return prog, prog.take_first()

    def _program(self, x: torch.Tensor, per_design: bool):
        key = ("multi", self.iso_key, self.k, per_design, self.sharded,
               str(self.device), tuple(int(d) for d in x.shape),
               dtype_name(x.dtype))
        built = {}

        def build():
            self.trace_count += 1
            if self.mesh is not None:
                prog = _ShardedProgram(self, x, self._params, per_design)
                built["first"], prog.first = prog.first, None
                return prog
            prog, built["first"] = self._build_one(x, self._params,
                                                   per_design, self._token())
            return prog

        prog, hit, _ = self.programs.get_or_build(key, build)
        return prog, hit, built.get("first")

    # -- dispatch -----------------------------------------------------------
    def run_int(self, x_int, *, per_design: bool = False) -> EmulationResult:
        """Emulate all K designs in one dispatch; every tensor in the
        result gains a leading design axis of size K."""
        x_int = torch.as_tensor(x_int, device=self.device)
        x_int = x_int.to(_CANONICAL.get(x_int.dtype, x_int.dtype))
        if per_design and int(x_int.shape[0]) != self.k:
            raise ValueError(
                f"per_design stimulus must lead with the design axis "
                f"(K={self.k}), got shape {tuple(x_int.shape)}")
        prog, hit, first = self._program(x_int, per_design)
        get_metrics().counter("rtl.multi.dispatch").inc()
        trc = get_tracer()
        if trc.enabled:
            with trc.span("rtl.multi.dispatch", k=self.k,
                          shape=str(tuple(x_int.shape)), cached=hit,
                          sharded=self.sharded,
                          design=self._base.graph.name):
                env = first if first is not None else \
                    prog(x_int, self._params, self._token())
        else:
            env = first if first is not None else \
                prog(x_int, self._params, self._token())
        g = self._base.graph
        fmt = g.edges[g.outputs[0]].fmt
        y = env[g.outputs[0]]
        return EmulationResult(outputs=y,
                               outputs_f=y.to(torch.float32) / fmt.scale,
                               trace=env)

    def run(self, x, *, per_design: bool = False) -> EmulationResult:
        g = self._base.graph
        in_fmt = g.edges[g.inputs[0]].fmt
        x = torch.as_tensor(x, device=self.device)
        return self.run_int(fxp_to_int(x, in_fmt).to(torch.int32),
                            per_design=per_design)

    # -- the sequential cross-check path ------------------------------------
    def run_int_sequential(self, x_int) -> np.ndarray:
        """Per-design ``fused`` dispatches through the shared LRU (one
        build in all); the reference the design axis must match integer
        for integer."""
        return np.stack([em.run_int(x_int).outputs.cpu().numpy()
                         .astype(np.int64) for em in self.emulators])
