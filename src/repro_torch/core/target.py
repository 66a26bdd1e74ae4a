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

Targets register by name (:func:`register_target`); the RTL target is a
lazy entry so ``repro_torch.rtl.backend`` imports only when first
requested. The reference's host target (``XLATarget``/``XLADeployment``)
and ``Deployment.guarded`` are not ported yet: the torch host target needs
the FLOP and byte counting of ROADMAP A10 (A7b), and the guarded wrapper
comes with the resilience layer (A9).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import (Any, Dict, Optional, Protocol, Tuple, Type, Union,
                    runtime_checkable)

import torch

from repro_torch.core.report import MeasurementReport, SynthesisReport
from repro_torch.energy.hw import HWSpec

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


register_lazy_target("rtl", "repro_torch.rtl.backend", "RTL_TARGET")
