"""The ElasticAI-Creator analogue: build → translate → estimate (port of
``repro/core/creator.py``).

The paper: *"the trained and optimized model can be translated to a hardware
accelerator in the RTL representation by simply pressing a button"*. Here the
button is :meth:`Creator.translate` — a thin dispatcher over the
deployment-target registry (:mod:`repro_torch.core.target`). Every
registered target turns a built stepper into the same two artifacts: a
:class:`SynthesisReport` (the Vivado-estimation analogue) and a
:class:`~repro_torch.core.target.Deployment` (callable, measurable,
savable).

The pre-registry spellings — ``translate(st, backend="rtl",
**rtl_formats)`` and :meth:`Creator.measure_rtl` — still work but emit a
``DeprecationWarning`` and forward to the registry path.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import registry
from repro_torch.core.report import MeasurementReport, SynthesisReport
from repro_torch.core.target import (DEFAULT_N_RUNS, Deployment,
                                     TargetOptions, TorchDeployment,
                                     get_target, model_flops_estimate)
from repro_torch.core.types import (SMOKE_MESH, MeshConfig, ModelConfig,
                                    ParallelismConfig, ShapeConfig)
from repro_torch.energy.hw import H100_SXM, HWSpec
from repro_torch.model.lm import Stepper
from repro_torch.obs import get_tracer


@dataclass
class Creator:
    """Builds steppers from registered components and translates them.

    ``hw`` is the spec translate estimates against (a target falls back to
    its own default where ``hw`` cannot serve it: the RTL target takes
    ``XC7S15`` in place of a clock-less GPU spec). ``device`` is where a
    deployment executes: ``None`` means CUDA, or raise."""

    hw: HWSpec = H100_SXM
    device: Optional[Union[str, torch.device]] = None

    def validate(self, cfg: ModelConfig) -> Dict[str, registry.Component]:
        return registry.validate_config(cfg)

    def build(self, cfg: ModelConfig, shape: ShapeConfig,
              mesh_cfg: MeshConfig = SMOKE_MESH,
              par: Optional[ParallelismConfig] = None) -> Stepper:
        self.validate(cfg)
        return Stepper(cfg, shape, mesh_cfg, par or ParallelismConfig())

    # ------------------------------------------------------------------ #
    # Stage 2: translate (= synthesize) + estimation report
    # ------------------------------------------------------------------ #
    def translate(self, st: Stepper, *, target="xla",
                  options: Optional[TargetOptions] = None,
                  params=None, kind: Optional[str] = None,
                  model_flops: Optional[float] = None,
                  backend: Optional[str] = None,
                  **rtl_formats) -> Tuple[SynthesisReport, Deployment]:
        """Press the button: returns (SynthesisReport, Deployment).

        ``target`` is a registered target name (``"xla"``, the host
        target, or ``"rtl"``; see
        :func:`repro_torch.core.target.list_targets`) or a Target instance.
        Target-specific knobs ride in ``options`` — the target's options
        dataclass (e.g. ``RTLOptions(w_fmt=..., emulator_mode=...)``);
        ``None`` means the target's defaults. ``params`` are the trained
        weights (targets that need them initialize from the stepper when
        omitted). ``kind`` / ``model_flops`` are convenience spellings for
        the matching options fields; a value already set on ``options``
        wins, and ``kind`` is ignored by targets whose options have no
        ``kind`` field.

        ``backend=`` and loose Q-format kwargs are the deprecated spelling;
        they forward here after a ``DeprecationWarning``.
        """
        if backend is not None or rtl_formats:
            warnings.warn(
                "Creator.translate(backend=..., **rtl_formats) is "
                "deprecated; use translate(st, target=..., "
                "options=<TargetOptions>)", DeprecationWarning, stacklevel=2)
            target = backend or target
            if rtl_formats:
                if target != "rtl":
                    raise TypeError(
                        f"unexpected kwargs {sorted(rtl_formats)} for "
                        f"target {target!r}")
                if options is not None:
                    raise TypeError(
                        "pass either options= or loose Q-format kwargs "
                        f"({sorted(rtl_formats)}), not both — the loose "
                        "kwargs would silently rebuild options from "
                        "defaults")
                from repro_torch.rtl.backend import RTLOptions

                options = RTLOptions(**rtl_formats)
        tgt = get_target(target)
        if options is None:
            options = tgt.options_cls()
        if not isinstance(options, tgt.options_cls):
            raise TypeError(
                f"target {tgt.name!r} expects options of type "
                f"{tgt.options_cls.__name__}, got "
                f"{type(options).__name__}")
        if kind is not None and hasattr(options, "kind"):
            options = dataclasses.replace(options, kind=kind)
        if model_flops is None and options.model_flops is None:
            model_flops = model_flops_estimate(st.cfg, st.shape)
        options = options.filled(hw=self.hw, model_flops=model_flops,
                                 device=self.device)
        with get_tracer().span("creator.translate", target=tgt.name,
                               arch=st.cfg.name):
            return tgt.translate(st.cfg, params, st, options)

    # ------------------------------------------------------------------ #
    # Stage 3: execute + measure
    # ------------------------------------------------------------------ #
    def measure(self, fn, args, *, model: str, model_flops: float,
                n_runs: int = DEFAULT_N_RUNS, hw: Optional[HWSpec] = None
                ) -> MeasurementReport:
        """Thin wrapper over :meth:`Deployment.measure`: a raw callable is
        wrapped into a :class:`TorchDeployment` on the Creator's HWSpec and
        device."""
        dep = fn if isinstance(fn, Deployment) else TorchDeployment(
            fn=fn, hw=hw or self.hw, device=self.device)
        return dep.measure(tuple(args), model=model,
                           model_flops=model_flops, n_runs=n_runs,
                           hw=hw or getattr(dep, "hw", self.hw))

    def measure_rtl(self, exe, x, *, model: str, model_flops: float,
                    hw: Optional[HWSpec] = None,
                    n_runs: int = DEFAULT_N_RUNS) -> MeasurementReport:
        """Deprecated: the RTL Deployment measures itself —
        ``deployment.measure((x,), model=..., model_flops=...)``."""
        warnings.warn(
            "Creator.measure_rtl is deprecated; call "
            "deployment.measure((x,), ...) on the Deployment returned by "
            "translate(st, target='rtl')", DeprecationWarning, stacklevel=2)
        return exe.measure((x,), model=model, model_flops=model_flops,
                           n_runs=n_runs, hw=hw)
