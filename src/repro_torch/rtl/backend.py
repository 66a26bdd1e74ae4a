"""The "press the button" entry point: model -> artifacts + report + emulator
(port of ``repro/rtl/backend.py``).

``RTL_TARGET`` is the registered deployment target behind
``Creator.translate(st, target="rtl")`` (DESIGN.md §8): lower the quantized
model to the dataflow IR, run the static analysis, instantiate the hardware
templates, cost the design against the FPGA HWSpec, and hand back an
:class:`RTLExecutable` — the RTL flavor of the uniform
:class:`~repro_torch.core.target.Deployment`, whose bit-exact emulator
(kernels B1 and B2 in ``fused`` mode on CUDA) stands in for the deployed
accelerator in the Workflow's stage-3 measurement (cycles × clock,
duty-cycled power).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.report import MeasurementReport, SynthesisReport
from repro_torch.core.target import DEFAULT_N_RUNS, Deployment, TargetOptions
from repro_torch.core.types import ModelConfig
from repro_torch.energy.hw import XC7S15, HWSpec
from repro_torch.model.layers import tree_map
from repro_torch.obs import get_metrics, get_tracer, percentile
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl.analyze import AnalysisError, analyze_graph
from repro_torch.rtl.diagnostics import AnalysisReport
from repro_torch.rtl.emit import emit_graph
from repro_torch.rtl.emulator import RTLEmulator
from repro_torch.rtl.ir import Graph, lower_model
from repro_torch.rtl.resources import estimate, synthesize

_EMULATOR_MODES = ("fused", "pallas", "jnp")
_ANALYZE_MODES = ("error", "warn", "off")


@dataclass(frozen=True)
class RTLOptions(TargetOptions):
    """Translate knobs for the RTL target — the Q-formats the design is
    quantized to and which emulator schedule executes it. Validation happens
    at construction so a Workflow knob sweep fails fast, not mid-lowering.

    ``w_fmt_overrides`` maps a registered template kind to the weight format
    *that* layer kind is quantized with; keys are validated against the
    hardware-template registry.
    """

    w_fmt: FxpFormat = FxpFormat(8, 6)
    act_fmt: FxpFormat = FxpFormat(8, 4)
    state_fmt: FxpFormat = FxpFormat(16, 8)
    emulator_mode: str = "fused"     # "fused" | "pallas" | "jnp"
    w_fmt_overrides: Optional[Mapping[str, FxpFormat]] = None
    #: static-verifier gate (DESIGN.md §13): "error" fails translate on any
    #: error-severity diagnostic, "warn" downgrades to a UserWarning,
    #: "off" skips the analysis pass entirely.
    analyze: str = "error"

    def __post_init__(self):
        if self.emulator_mode not in _EMULATOR_MODES:
            raise ValueError("emulator_mode must be one of "
                             f"{_EMULATOR_MODES}, got "
                             f"{self.emulator_mode!r}")
        if self.analyze not in _ANALYZE_MODES:
            raise ValueError(f"analyze must be one of {_ANALYZE_MODES}, "
                             f"got {self.analyze!r}")
        for name in ("w_fmt", "act_fmt", "state_fmt"):
            fmt = getattr(self, name)
            if not isinstance(fmt, FxpFormat):
                raise TypeError(f"{name} must be an FxpFormat, got "
                                f"{type(fmt).__name__}")
        if self.w_fmt_overrides is not None:
            from repro_torch.rtl.oplib import get_template, list_templates

            for kind, fmt in self.w_fmt_overrides.items():
                tmpl = get_template(kind)    # unknown kind raises, listing
                if not tmpl.has_weights:
                    weighted = [k for k in list_templates()
                                if get_template(k).has_weights]
                    raise ValueError(
                        f"w_fmt_overrides[{kind!r}]: template {kind!r} "
                        "carries no weight format; weight-carrying "
                        f"kinds: {weighted}")
                if not isinstance(fmt, FxpFormat):
                    raise TypeError(
                        f"w_fmt_overrides[{kind!r}] must be an FxpFormat, "
                        f"got {type(fmt).__name__}")


def _sync(device: torch.device) -> None:
    """Wait for the device: a CUDA call returns before the work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class RTLExecutable(Deployment):
    """The compiled-artifact analogue returned by ``translate(target="rtl")``.

    Feeding it a float batch runs the bit-exact emulator on ``device``
    (``None`` means CUDA) and yields dequantized outputs. Weights live on
    the device from construction, so this object is cheap to call in
    verification/measurement loops.

    As a :class:`Deployment`, it measures itself off the cycle-accurate
    schedule (``bind_step`` is a no-op — the emulator *is* the deployed
    design; timing a host step fn would measure the wrong substrate).
    """

    graph: Graph
    artifacts: Dict[str, str]
    hw: HWSpec
    emulator_mode: str = "fused"     # "fused" | "pallas" | "jnp"
    #: the static verifier's report (None when translated with analyze="off")
    analysis: Optional[AnalysisReport] = None
    device: Optional[Union[str, torch.device]] = None
    emulator: RTLEmulator = field(init=False)

    target = "rtl"

    def __post_init__(self):
        self.emulator = RTLEmulator(self.graph, mode=self.emulator_mode,
                                    device=self.device)
        self.device = self.emulator.device

    def __call__(self, x) -> torch.Tensor:
        return self.emulator.run(x).outputs_f

    def run_many(self, xs) -> list:
        """Batched-throughput entry: see :meth:`RTLEmulator.run_many`."""
        return self.emulator.run_many(xs)

    def holds_program(self, shape, dtype) -> bool:
        """Serving-router affinity probe: does the emulator already hold a
        program for this float input ``(shape, dtype)``? Float inputs
        quantize to int32 before dispatch, so the emulator key is
        ``(shape, int32)``. ``dataclasses.replace(exe)`` re-runs
        ``__post_init__``: each replica owns a fresh emulator and cache."""
        return self.emulator.has_program(shape, torch.int32)

    @property
    def cycles(self) -> int:
        return estimate(self.graph,
                        clock_hz=self.hw.clock_hz or 100e6).cycles

    def measure(self, args, *, model: str, model_flops: float,
                n_runs: int = DEFAULT_N_RUNS, warmup: int = 1,
                hw: Optional[HWSpec] = None) -> MeasurementReport:
        """Stage 3 on the generated accelerator: execute the emulator (the
        deployed design's proxy) ``n_runs`` times, then read latency/power
        off the cycle-accurate schedule — emulator cycles × clock,
        duty-cycled power via :meth:`HWSpec.energy_j`.

        ``args`` follows the Deployment convention: the trailing positional
        is the input batch (leading entries, e.g. params from a Workflow
        step_builder, are already baked into the deployed design).

        ``warmup`` runs execute first and are **excluded** from the latency
        samples (and thus from ``latency_p50/p99_s``). Each sample is the
        host clock around one run that ends in a device synchronise.
        """
        x = args[-1] if isinstance(args, (tuple, list)) else args
        hw = hw or self.hw
        clock = hw.clock_hz or 100e6
        rr = estimate(self.graph, clock_hz=clock)
        n_runs = max(1, n_runs)
        samples = []
        with get_tracer().span("rtl.measure", model=model, n_runs=n_runs,
                               warmup=warmup):
            for _ in range(max(0, warmup)):     # excluded from percentiles
                self(x)
                _sync(self.device)
            for _ in range(n_runs):             # actually execute the design
                t0 = time.perf_counter()
                self(x)
                _sync(self.device)
                samples.append(time.perf_counter() - t0)
        hist = get_metrics().histogram("measure.latency_s.rtl")
        for s in samples:
            hist.observe(s)
        latency = rr.latency_s
        energy = hw.energy_j(latency, duty=rr.duty)
        return MeasurementReport(
            model=model, platform=f"rtl-emulator({hw.name})",
            latency_s=latency,
            power_w=energy / latency if latency else 0.0,
            energy_j=energy,
            gop_per_j=(model_flops / 1e9) / energy if energy else 0.0,
            n_runs=n_runs, target=self.target,
            # the fabric latency above is the cycle model (deterministic);
            # the percentiles characterize the per-run distribution of the
            # executing proxy — what a tail-latency acceptance gate reads
            latency_p50_s=percentile(samples, 50),
            latency_p99_s=percentile(samples, 99))

    def save(self, build_dir: str) -> None:
        import os

        from repro_torch.rtl.emit import write_artifacts

        write_artifacts(self.artifacts, build_dir)
        if self.analysis is not None:
            path = os.path.join(build_dir, "analysis.json")
            with open(path, "w", encoding="utf-8") as f:
                f.write(self.analysis.to_json())


class RTLTarget:
    """The ElasticAI-Creator codegen analogue as a registered target."""

    name = "rtl"
    default_hw = XC7S15
    options_cls = RTLOptions
    requires_stepper = True          # must lower the real model graph

    def options_from_knobs(self, knobs) -> RTLOptions:
        """Workflow knobs -> valid RTL Q-formats, clamped to the exactness
        envelope (DESIGN.md §4): the DSP path caps weights at 12 bits and
        LUT inputs at 9. Knob dicts without ``bits`` get the target
        defaults."""
        if "bits" not in knobs:
            return RTLOptions()
        bits = int(knobs["bits"])
        frac = int(knobs.get("frac", max(1, bits - 2)))
        wb = min(bits, 12)
        ab = min(bits, 9)
        return RTLOptions(
            w_fmt=FxpFormat(wb, min(frac, wb - 1)),
            act_fmt=FxpFormat(ab, min(max(0, frac - 2), ab - 1, 8)))

    def translate(self, cfg, params, stepper,
                  options: RTLOptions) -> Tuple[SynthesisReport,
                                                RTLExecutable]:
        if params is None:
            params = stepper.init(device=options.device)
        # a clock-less HWSpec (a GPU) can't be the fabric target: fall back
        hw = options.hw if (options.hw is not None
                            and options.hw.clock_hz) else self.default_hw
        return translate_rtl(cfg, params, hw=hw,
                             model_flops=options.model_flops or 0.0,
                             w_fmt=options.w_fmt, act_fmt=options.act_fmt,
                             state_fmt=options.state_fmt,
                             emulator_mode=options.emulator_mode,
                             w_fmt_overrides=options.w_fmt_overrides,
                             analyze=options.analyze, device=options.device)


RTL_TARGET = RTLTarget()


def _host(params):
    """Trained parameters (tensors on any device, or arrays) as float32
    numpy arrays, which the lowering reads."""
    return tree_map(lambda a: a.detach().cpu().numpy()
                    if isinstance(a, torch.Tensor)
                    else np.asarray(a, np.float32), params)


def translate_rtl(cfg: ModelConfig, params, *,
                  hw: HWSpec = XC7S15,
                  w_fmt: FxpFormat = FxpFormat(8, 6),
                  act_fmt: FxpFormat = FxpFormat(8, 4),
                  state_fmt: FxpFormat = FxpFormat(16, 8),
                  model_flops: float = 0.0,
                  emulator_mode: str = "fused",
                  w_fmt_overrides=None,
                  analyze: str = "error",
                  device: Optional[Union[str, torch.device]] = None):
    """Returns (SynthesisReport, RTLExecutable); the executable's emulator
    lives on ``device`` (None means CUDA).

    ``analyze`` gates the static verifier (DESIGN.md §13) between lowering
    and emit: ``"error"`` raises :class:`~repro_torch.rtl.analyze.
    AnalysisError` on any error-severity diagnostic (fail fast, before
    codegen), ``"warn"`` surfaces them as a UserWarning, ``"off"`` skips
    the pass.
    """
    import warnings

    if analyze not in _ANALYZE_MODES:
        raise ValueError(f"analyze must be one of {_ANALYZE_MODES}, "
                         f"got {analyze!r}")
    trc = get_tracer()
    with trc.span("rtl.lower", arch=cfg.name):
        graph = lower_model(cfg, _host(params), w_fmt=w_fmt,
                            act_fmt=act_fmt, state_fmt=state_fmt,
                            w_fmt_overrides=w_fmt_overrides)
    analysis = None
    if analyze != "off":
        with trc.span("rtl.analyze", arch=cfg.name):
            analysis = analyze_graph(graph, hw=hw)
        if not analysis.passed:
            if analyze == "error":
                raise AnalysisError(analysis)
            warnings.warn("static analysis found "
                          f"{len(analysis.errors)} error(s):\n"
                          f"{analysis.format()}", UserWarning,
                          stacklevel=2)
    with trc.span("rtl.emit", arch=cfg.name):
        artifacts = emit_graph(graph)
    with trc.span("rtl.synthesize", arch=cfg.name):
        rep = synthesize(graph, hw=hw, model_flops=model_flops,
                         n_artifacts=len(artifacts))
    return rep, RTLExecutable(graph=graph, artifacts=artifacts, hw=hw,
                              emulator_mode=emulator_mode,
                              analysis=analysis, device=device)


def measure_rtl(exe: RTLExecutable, x, *, model: str,
                model_flops: float, hw: Optional[HWSpec] = None,
                n_runs: int = DEFAULT_N_RUNS) -> MeasurementReport:
    """Functional spelling of :meth:`RTLExecutable.measure` (kept for
    direct use; the Workflow goes through the Deployment method)."""
    return exe.measure((x,), model=model, model_flops=model_flops,
                       hw=hw, n_runs=n_runs)
