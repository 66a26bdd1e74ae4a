"""Pluggable deployment targets — the registry behind ``Creator.translate``
(port of ``repro/core/target.py``).

Two abstractions (DESIGN.md §8):

* A :class:`Target` — a named translation backend. Each target declares its
  ``name``, a ``default_hw`` :class:`HWSpec`, an ``options_cls`` dataclass
  (the *only* place target-specific knobs live), an ``options_from_knobs``
  hook that maps Workflow knob dicts onto valid options, and
  ``translate(cfg, params, stepper, options) -> (SynthesisReport,
  Deployment)``.

* A :class:`Deployment` — the uniform stage-3 artifact every target returns:
  callable on inputs, measurable (:meth:`Deployment.measure`, one
  documented ``n_runs`` default for every target), savable, verifiable, and
  carrying ``target``/``cycles`` metadata.

Targets register by name (:func:`register_target`): the host target
(:class:`TorchTarget`) eagerly, the RTL target as a lazy entry so
``repro_torch.rtl.backend`` imports only when first requested.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Optional, Protocol, Tuple, Type,
                    Union, runtime_checkable)

import torch

from repro_torch.core.report import MeasurementReport, SynthesisReport
from repro_torch.device import resolve_device
from repro_torch.energy.cost import count_step
from repro_torch.energy.hw import H100_SXM, HWSpec
from repro_torch.energy.meter import channel_report
from repro_torch.energy.roofline import roofline
from repro_torch.obs import get_metrics, get_tracer, percentile

#: The single documented stage-3 measurement default, shared by every
#: target.
DEFAULT_N_RUNS = 20


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (forward-only serving)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


# --------------------------------------------------------------------------- #
# Options — the per-target translate knobs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class TargetOptions:
    """Base for every target's options dataclass.

    ``hw`` / ``model_flops`` / ``device`` are shared across targets;
    ``Creator.translate`` fills them (from its own ``hw`` and ``device``
    and the cfg/shape FLOP estimate) when the caller leaves them ``None``.
    ``device`` is where the deployment executes: ``None`` means CUDA (and
    raises on a host without it).
    """

    hw: Optional[HWSpec] = None
    model_flops: Optional[float] = None
    device: Optional[Union[str, torch.device]] = None

    def filled(self, *, hw: Optional[HWSpec], model_flops: Optional[float],
               device: Optional[Union[str, torch.device]] = None
               ) -> "TargetOptions":
        """Return a copy with unset shared fields defaulted."""
        return dataclasses.replace(
            self,
            hw=self.hw if self.hw is not None else hw,
            model_flops=(self.model_flops if self.model_flops is not None
                         else model_flops),
            device=self.device if self.device is not None else device)


@dataclass(frozen=True)
class TorchOptions(TargetOptions):
    """Options for the host target.

    ``kind`` overrides the stepper shape's program kind
    ("train" | "prefill" | "decode"); ``None`` uses ``stepper.shape.kind``.
    """

    kind: Optional[str] = None

    _KINDS = (None, "train", "prefill", "decode")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError("TorchOptions.kind must be one of "
                             f"{self._KINDS[1:]} or None, got {self.kind!r}")


# --------------------------------------------------------------------------- #
# Deployment — the uniform stage-3 artifact
# --------------------------------------------------------------------------- #


class Deployment:
    """What ``Target.translate`` hands back next to the SynthesisReport.

    The uniform contract, regardless of substrate:

    * callable on inputs (``deployment(*args)`` runs the deployed design);
    * :meth:`measure` executes it and returns a :class:`MeasurementReport`
      that records ``n_runs`` and the target name;
    * :meth:`save` writes the deployable artifacts to a build directory;
    * :meth:`verify` runs it through the Elastic Node conformance check;
    * ``target`` (name) and ``cycles`` (cycle-schedule length, ``None`` when
      the substrate has no fabric clock) are inspectable metadata;
    * :meth:`bind_step` lets the Workflow hand over the concrete step
      function it wants timed — host-executed targets measure that
      callable, targets with their own execution substrate (the RTL
      emulator) ignore it.
    """

    target = ""
    cycles: Optional[int] = None

    def __call__(self, *args):
        raise NotImplementedError

    def bind_step(self, fn) -> "Deployment":
        """Default: the deployment is its own executor."""
        return self

    def measure(self, args, *, model: str, model_flops: float,
                n_runs: int = DEFAULT_N_RUNS, warmup: int = 1,
                hw: Optional[HWSpec] = None) -> MeasurementReport:
        """Execute ``warmup`` unrecorded runs, then ``n_runs`` timed ones.

        Warmup runs are part of the contract: first-call cost must be
        excluded from the latency samples, so ``latency_p50_s``/
        ``latency_p99_s`` characterize steady-state tails only."""
        raise NotImplementedError

    def save(self, build_dir: str) -> None:
        raise NotImplementedError

    def verify(self, args=None, *, model: str, model_flops: float,
               hw: Optional[HWSpec] = None, protocol=None, oracle=None):
        """Elastic Node conformance: run this deployment through
        :func:`repro_torch.verify.verify_deployment` and return its
        :class:`~repro_torch.verify.ConformanceReport` — for RTL
        deployments every emulator mode mutually bit-exact over the
        design's golden vectors, the int output within the error budget of
        the float oracle, plus the measurement protocol. ``args`` follows
        the :meth:`measure` convention and may be omitted for
        self-executing targets (the golden stimulus stands in).
        """
        from repro_torch.verify import verify_deployment

        return verify_deployment(self, args, model=model,
                                 model_flops=model_flops, hw=hw,
                                 protocol=protocol, oracle=oracle)

    def guarded(self, **kwargs) -> "Deployment":
        """Wrap this deployment for fault-tolerant serving: per-call
        timeout, bounded retry, circuit breaker, golden-vector canary
        probes, and graceful fallback (``repro_torch.resilience``,
        DESIGN.md §12). Keyword arguments go to
        :class:`~repro_torch.resilience.GuardedDeployment` (``policy=``,
        ``fallback=``, ``canary=``, injectable ``clock``/``rng``, ...).
        Part of the uniform contract so a pool can guard any target the
        registry produces.
        """
        from repro_torch.resilience import GuardedDeployment

        return GuardedDeployment(self, **kwargs)


def _sync(device: torch.device) -> None:
    """Wait for the device: a CUDA call returns before the work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TorchDeployment(Deployment):
    """The host target's deployment: a torch step function run on
    ``device`` (``None`` means CUDA, or raise), timed on the host clock,
    with duty-1 power from the HWSpec.

    A prefill or decode step runs under ``torch.inference_mode()``, so no
    activation is kept for a backward pass; a train step (``kind ==
    "train"``) runs with autograd. ``ops_text`` is the counted op list
    (:meth:`repro_torch.energy.cost.StepCost.as_text`), ``cost`` the
    step's ``flops``, ``bytes_accessed``, ``wire_bytes`` and the roofline's
    ``est_latency_s``.
    """

    fn: Optional[Callable] = None
    hw: HWSpec = H100_SXM
    ops_text: str = ""
    cost: Dict[str, float] = field(default_factory=dict)
    device: Optional[Union[str, torch.device]] = None
    kind: Optional[str] = None

    target = "xla"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __call__(self, *args):
        with torch.inference_mode(self.kind != "train"):
            return self.fn(*args)

    def bind_step(self, fn) -> "TorchDeployment":
        """Run ``fn`` instead of the translated step, keeping the
        translate-time metadata (op list, cost) on the new artifact."""
        return dataclasses.replace(self, fn=fn)

    def measure(self, args, *, model: str, model_flops: float,
                n_runs: int = DEFAULT_N_RUNS, warmup: int = 1,
                hw: Optional[HWSpec] = None) -> MeasurementReport:
        """Time ``n_runs`` calls, each on the host clock around a run that
        ends in a device synchronise, so the report carries real p50/p99
        percentiles, not just the mean. The ``warmup`` calls run first and
        never enter the samples: the first call on a fresh machine builds
        the CUDA kernels it launches.

        A decode step writes the new token's K/V into the cache it is given
        in place and leaves that cache's positions as they were, so every
        run times the same position: the same work each time, as the
        reference's donated cache gives it."""
        hw = hw or self.hw
        n_runs = max(1, n_runs)
        samples = []
        with get_tracer().span("xla.measure", model=model, n_runs=n_runs,
                               warmup=warmup):
            for _ in range(max(0, warmup)):     # excluded from percentiles
                self(*args)
                _sync(self.device)
            for _ in range(n_runs):
                t0 = time.perf_counter()
                self(*args)
                _sync(self.device)
                samples.append(time.perf_counter() - t0)
        hist = get_metrics().histogram("measure.latency_s.xla")
        for s in samples:
            hist.observe(s)
        lat = sum(samples) / n_runs
        energy = hw.energy_j(lat)
        platform = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else self.device.type)
        return MeasurementReport(
            model=model, platform=platform, latency_s=lat,
            power_w=hw.active_w, energy_j=energy,
            gop_per_j=(model_flops / 1e9) / energy if energy else 0.0,
            n_runs=n_runs, target=self.target,
            latency_p50_s=percentile(samples, 50),
            latency_p99_s=percentile(samples, 99))

    def save(self, build_dir: str) -> None:
        """Artifacts for this substrate: the op list plus a manifest."""
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, "module.ops.txt"), "w") as f:
            f.write(self.ops_text)
        with open(os.path.join(build_dir, "deployment.json"), "w") as f:
            json.dump({"target": self.target, "hw": self.hw.name,
                       "cost": self.cost}, f, indent=2)


# --------------------------------------------------------------------------- #
# Target protocol + registry
# --------------------------------------------------------------------------- #


@runtime_checkable
class Target(Protocol):
    """What a translation backend must provide to plug into the toolchain."""

    name: str
    default_hw: HWSpec
    options_cls: Type[TargetOptions]
    #: Workflow refuses step-fn-only operation for targets that must lower a
    #: real Stepper (e.g. RTL needs the model graph, not a closed-over fn).
    requires_stepper: bool

    def options_from_knobs(self, knobs: Dict[str, Any]) -> TargetOptions:
        """Map Workflow knobs onto a *valid* options instance."""
        ...

    def translate(self, cfg, params, stepper,
                  options: TargetOptions) -> Tuple[SynthesisReport,
                                                   Deployment]:
        ...


_REGISTRY: Dict[str, Target] = {}
#: name -> (module, attribute); resolved on first get_target() so heavyweight
#: backends don't import until requested.
_LAZY: Dict[str, Tuple[str, str]] = {}


def register_target(target: Target, *, overwrite: bool = False) -> Target:
    """Register ``target`` under ``target.name``. Registering a name twice is
    an error unless ``overwrite=True`` (lazy placeholders may be overwritten
    by the concrete target they resolve to)."""
    name = target.name
    if not overwrite and (name in _REGISTRY or name in _LAZY):
        raise ValueError(f"target {name!r} already registered "
                         f"(registered: {list_targets()})")
    _LAZY.pop(name, None)
    _REGISTRY[name] = target
    return target


def register_lazy_target(name: str, module: str, attr: str) -> None:
    """Register a target import path, deferring the import to first use."""
    if name in _REGISTRY or name in _LAZY:
        raise ValueError(f"target {name!r} already registered "
                         f"(registered: {list_targets()})")
    _LAZY[name] = (module, attr)


def list_targets() -> list:
    """Names of every registered target (lazy ones included), sorted."""
    return sorted(set(_REGISTRY) | set(_LAZY))


def get_target(name) -> Target:
    """Resolve a target by name (or pass a Target instance through).

    Unknown names raise ``ValueError`` listing what *is* registered, so the
    error message doubles as discovery.
    """
    if not isinstance(name, str):               # already a Target
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _LAZY:
        module, attr = _LAZY[name]
        target = getattr(importlib.import_module(module), attr)
        register_target(target, overwrite=True)
        return target
    raise ValueError(f"unknown target {name!r}; "
                     f"registered targets: {list_targets()}")


# --------------------------------------------------------------------------- #
# The host target
# --------------------------------------------------------------------------- #


def abstract_inputs(st, kind: str, params=None) -> tuple:
    """The arguments of ``kind``'s step of the stepper ``st`` as ``meta``
    tensors (:meth:`~repro_torch.model.lm.Stepper.abstract_inputs`), the
    params from ``params`` where given (shapes and dtypes only), with the
    optimizer state beside them."""
    from repro_torch.model.layers import abstract_params
    from repro_torch.optim.adamw import init_opt_state

    a = dataclasses.replace(
        st, shape=dataclasses.replace(st.shape, kind=kind)).abstract_inputs()
    if params is not None:
        a["params"] = abstract_params(params)
        if kind == "train":
            a["opt_state"] = init_opt_state(a["params"])
    if kind == "train":
        return a["params"], a["opt_state"], a["batch"]
    if kind == "prefill":
        return a["params"], a["batch"]
    return a["params"], a["batch"]["tokens"], a["cache"]


class TorchTarget:
    """The host-executed target: the stepper's torch step run on the card,
    reported through the roofline and the 8-channel meter of its counted
    program (the Vivado-estimation analogue).

    Registered under the reference's name for its host target, ``"xla"``,
    so ``Workflow(target="xla")``, ``--target xla`` and the reports'
    ``target`` read as the reference's do; no XLA runs. Translating counts
    the step (:func:`repro_torch.energy.cost.count_step`) on ``meta``
    tensors built from the schema, the reference's abstract lowering:
    nothing executes and no second copy of the weights is made.
    """

    name = "xla"
    default_hw = H100_SXM
    options_cls = TorchOptions
    requires_stepper = False

    def options_from_knobs(self, knobs: Dict[str, Any]) -> TorchOptions:
        return TorchOptions()

    def translate(self, cfg, params, st, options: TorchOptions
                  ) -> Tuple[SynthesisReport, TorchDeployment]:
        """Count ``kind``'s step of ``st`` on ``meta`` inputs (``params``,
        where given, lend only their shapes and dtypes) and report it on
        ``options.hw``. ``compile_seconds`` is this call's wall time; the
        kernels the step launches are built at its first call, which a
        measurement's warmup absorbs."""
        hw = options.hw or self.default_hw
        kind = options.kind or st.shape.kind
        device = resolve_device(options.device)
        model_flops = options.model_flops
        if model_flops is None:
            model_flops = model_flops_estimate(st.cfg, st.shape)
        trc = get_tracer()
        t0 = time.perf_counter()
        with trc.span("xla.lower", arch=st.cfg.name, kind=kind):
            fn = {"train": st.train_fn, "prefill": st.prefill_fn,
                  "decode": st.decode_fn}[kind]()
            with torch.inference_mode(kind != "train"):
                cost = count_step(fn, abstract_inputs(st, kind, params))
        with trc.span("xla.compile", arch=st.cfg.name, kind=kind):
            rep = roofline(arch=st.cfg.name, shape=st.shape.name,
                           mesh="1dev", n_devices=1,
                           cost=cost.cost_analysis(),
                           hlo_text=cost.as_text(),
                           model_flops=model_flops, hw=hw)
            ch = channel_report(cost.work, cost.op_counts, hw)
        compile_s = time.perf_counter() - t0

        peak = (cost.argument_bytes + cost.temp_bytes + cost.output_bytes
                - cost.alias_bytes)
        est_latency = rep.step_s
        est_energy = ch.total_joules + hw.idle_w * est_latency
        syn = SynthesisReport(
            model=st.cfg.name, target=hw.name,
            argument_bytes=cost.argument_bytes,
            output_bytes=cost.output_bytes, temp_bytes=cost.temp_bytes,
            fits=peak <= hw.hbm_bytes, utilization=peak / hw.hbm_bytes,
            flops=rep.flops_per_device, bytes_accessed=rep.bytes_per_device,
            wire_bytes=rep.wire_bytes_per_device,
            est_latency_s=est_latency,
            est_power_w=est_energy / est_latency if est_latency else 0.0,
            est_energy_j=est_energy,
            est_gop_per_j=(rep.model_flops / 1e9) / est_energy
            if est_energy else 0.0,
            bottleneck=rep.bottleneck, channels=ch.seconds,
            channel_joules=ch.joules, compile_seconds=compile_s,
            backend=self.name)
        dep = TorchDeployment(
            fn=fn, hw=hw, ops_text=cost.as_text(), device=device, kind=kind,
            cost={"flops": syn.flops, "bytes_accessed": syn.bytes_accessed,
                  "wire_bytes": syn.wire_bytes,
                  "est_latency_s": syn.est_latency_s})
        return syn, dep


TORCH_TARGET = register_target(TorchTarget())
register_lazy_target("rtl", "repro_torch.rtl.backend", "RTL_TARGET")
