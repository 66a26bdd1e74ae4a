"""The ElasticAI-Workflow: three stages + feedback loop, as a first-class API
(port of ``repro/core/workflow.py``).

Stage 1  design/train/quantize (PyTorch, as in the paper)
Stage 2  translate + synthesize -> estimation reports
Stage 3  deploy + measure -> measurement reports

"The optimization loop will not terminate until the developers are satisfied
with the reports" — :meth:`Workflow.run` iterates candidate tweaks (provided
by an ``optimizer`` callback) until the requirement predicate accepts the
stage-3 measurement or the tweak budget is exhausted.

Every deployment target runs through the *same* :meth:`Workflow.run_once`:
stage 2 resolves the target from the registry and translates to the uniform
:class:`~repro_torch.core.target.Deployment` artifact, stage 3 measures
that artifact. Target-specific knob mapping lives on the target
(``Target.options_from_knobs``), overridable per-workflow via
``options_from_knobs``. The older spellings (``backend=``,
``fmt_builder=``) still construct but emit a ``DeprecationWarning`` and
forward. ``resilience=`` adds the scripted chaos stage: fault injection
under a guarded wrapper with RTL→host fallback, scored on the golden
vectors (:mod:`repro_torch.resilience`).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.creator import Creator
from repro_torch.core.report import (DesignReport, MeasurementReport,
                                     SynthesisReport, compare)
from repro_torch.core.target import (TargetOptions, TorchDeployment,
                                     get_target)
from repro_torch.energy.cost import StepCost, count_step
from repro_torch.energy.meter import channel_report
from repro_torch.energy.roofline import roofline
from repro_torch.obs import get_tracer


def chaos_fallback(dep, hw):
    """The chaos stage's fallback for a graph-carrying deployment: the float
    oracle of the *same lowered graph* (``reference_apply``) as a host
    deployment on the deployment's device, registered under the host
    target's name ``"xla"``. Same SynthesisReport lineage, so degradation
    changes the substrate (and its energy/accuracy class), not the function
    being served. Its f32 matmuls are held in IEEE precision, where the
    oracle is exact: a TF32 product could turn a degraded answer into a
    corrupted one."""
    from repro_torch.resilience import FallbackPolicy
    from repro_torch.rtl.emulator import reference_apply
    from repro_torch.verify.conformance import exact_f32_matmul

    graph, device = dep.graph, getattr(dep, "device", None)

    def oracle(x):
        with exact_f32_matmul():
            return reference_apply(graph, x, device=device)

    return FallbackPolicy.to_xla(TorchDeployment(fn=oracle, hw=hw,
                                                 device=device))


@dataclass
class Requirement:
    """What "the application requires" — the workflow's stop condition."""

    max_latency_s: float = float("inf")
    max_energy_j: float = float("inf")
    min_gop_per_j: float = 0.0
    max_eval_loss: float = float("inf")

    def satisfied(self, d: DesignReport, m: MeasurementReport) -> bool:
        return (m.latency_s <= self.max_latency_s
                and m.energy_j <= self.max_energy_j
                and m.gop_per_j >= self.min_gop_per_j
                and d.eval_loss <= self.max_eval_loss)


@dataclass
class WorkflowRecord:
    """One trip around the loop — design, estimate, measurement, verdict."""

    iteration: int
    knobs: Dict[str, Any]
    design: DesignReport
    synthesis: SynthesisReport
    measurement: MeasurementReport
    est_vs_meas: Dict[str, float]
    satisfied: bool
    #: ConformanceReport from the verify stage (None when verify=False)
    conformance: Optional[Any] = None
    #: ResilienceReport from the chaos stage (None when resilience=None)
    resilience: Optional[Any] = None
    #: AnalysisReport from the static-verifier stage (None for targets
    #: without one, or when the workflow runs with analyze="off")
    analysis: Optional[Any] = None


@dataclass
class Workflow:
    """Drives stage1/stage2/stage3 for one model family.

    The user supplies the callables, mirroring how a DL developer plugs
    their task into the ElasticAI toolchain:
      train_fn(knobs)  -> (params, DesignReport, apply_fn)
      step_builder(knobs, params) -> (fn, args, model_flops)   # deployable
      stepper_builder(knobs) -> Stepper                        # to lower
    ``target`` names a registered deployment target; targets that must
    lower the real model graph (e.g. "rtl") additionally need
    ``stepper_builder``, the host target ("xla") without it counts and
    times the step function itself. ``options_from_knobs`` overrides the
    target's own knob→options mapping.
    """

    creator: Creator
    train_fn: Callable[[Dict[str, Any]], Tuple[Any, DesignReport, Any]]
    step_builder: Callable[[Dict[str, Any], Any], Tuple[Any, tuple, float]]
    stepper_builder: Optional[Callable[[Dict[str, Any]], Any]] = None
    target: str = "xla"
    options_from_knobs: Optional[
        Callable[[Dict[str, Any]], TargetOptions]] = None
    #: run the Elastic Node conformance stage (Deployment.verify) after
    #: every stage-3 measurement and attach its report to the record
    verify: bool = False
    #: run this ChaosSpec against the deployed artifact after every stage-3
    #: measurement (resilience.ChaosSpec; graph-carrying targets only)
    resilience: Optional[Any] = None
    #: static-verifier gate override ("error" | "warn" | "off"): forwarded
    #: into the target options when they carry an ``analyze`` field (the
    #: RTL target does); the report lands in ``WorkflowRecord.analysis``
    analyze: Optional[str] = None
    # deprecated spellings (forwarded in __post_init__):
    backend: Optional[str] = None
    fmt_builder: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    history: List[WorkflowRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.backend is not None:
            warnings.warn("Workflow(backend=...) is deprecated; use "
                          "Workflow(target=...)", DeprecationWarning,
                          stacklevel=3)
            self.target = self.backend
        if self.fmt_builder is not None:
            warnings.warn(
                "Workflow(fmt_builder=...) is deprecated; use "
                "options_from_knobs returning the target's options "
                "dataclass (or rely on Target.options_from_knobs)",
                DeprecationWarning, stacklevel=3)
            # the old loop only consumed fmt_builder on the RTL fork and
            # ignored it elsewhere — preserve that
            if self.options_from_knobs is None and self.target == "rtl":
                fb = self.fmt_builder

                def _from_fmts(knobs: Dict[str, Any]) -> TargetOptions:
                    from repro_torch.rtl.backend import RTLOptions

                    return RTLOptions(**fb(knobs))

                self.options_from_knobs = _from_fmts

    def run_once(self, knobs: Dict[str, Any], it: int = 0) -> WorkflowRecord:
        """One loop iteration — the single code path for every target.

        The iteration runs under a ``workflow.run_once`` span with one child
        per stage (``workflow.stage1`` … ``workflow.stage3``,
        ``workflow.verify``, ``workflow.analyze``,
        ``workflow.resilience``), knobs attached as
        attrs — so spans captured around this call decompose where the loop
        spends its time, down to the emulator runs nested inside stage 3.
        """
        trc = get_tracer()
        with trc.span("workflow.run_once", iteration=it, target=self.target,
                      **{f"knob.{k}": v for k, v in knobs.items()}):
            # Stage 1 — design / train / quantize
            with trc.span("workflow.stage1", stage="design/train/quantize"):
                params, design, _ = self.train_fn(knobs)
            # Stage 2 — translate + estimate via the target registry
            with trc.span("workflow.stage2",
                          stage="translate/estimate") as s2:
                tgt = get_target(self.target)
                opts_fn = self.options_from_knobs or tgt.options_from_knobs
                options = opts_fn(knobs)
                if self.analyze is not None:
                    options = self._with_analyze(options)
                fn, args, model_flops = self.step_builder(knobs, params)
                if self.stepper_builder is not None:
                    st = self.stepper_builder(knobs)
                    syn, dep = self.creator.translate(
                        st, target=tgt, options=options, params=params,
                        model_flops=model_flops)
                elif getattr(tgt, "requires_stepper", False):
                    raise ValueError(f"target {tgt.name!r} needs "
                                     "stepper_builder (the model to lower)")
                else:
                    syn, cost = self._synth_from_fn(fn, args, model_flops,
                                                    model=design.model)
                    dep = TorchDeployment(
                        fn=None, hw=self.creator.hw,
                        device=self.creator.device, ops_text=cost.as_text(),
                        cost={"flops": syn.flops,
                              "bytes_accessed": syn.bytes_accessed,
                              "wire_bytes": syn.wire_bytes,
                              "est_latency_s": syn.est_latency_s})
                s2.set_attrs(model=design.model,
                             compile_seconds=syn.compile_seconds)
            # Stage 3 — deploy + measure through the uniform Deployment
            # artifact. Host-executed targets time the step function;
            # self-executing targets (the RTL emulator) ignore the bound
            # step function and measure themselves.
            with trc.span("workflow.stage3", stage="deploy/measure") as s3:
                dep = dep.bind_step(fn) if fn is not None else dep
                meas = dep.measure(args, model=design.model,
                                   model_flops=model_flops)
                s3.set_attrs(latency_s=meas.latency_s,
                             latency_p99_s=meas.latency_p99_s)
            # Verify stage — the Elastic Node half of the paper's loop
            conf = None
            if self.verify:
                with trc.span("workflow.verify") as sv:
                    conf = dep.verify(args, model=design.model,
                                      model_flops=model_flops)
                    sv.set_attrs(passed=conf.passed)
            # Analyze stage — the static verifier's report, produced by
            # graph-lowering targets during translate (DESIGN.md §13),
            # surfaced as its own span
            analysis = getattr(dep, "analysis", None)
            if analysis is not None:
                with trc.span("workflow.analyze") as sa:
                    sa.set_attrs(passed=analysis.passed,
                                 errors=len(analysis.errors),
                                 warnings=len(analysis.warnings))
            # Resilience stage — scripted chaos against the deployed
            # artifact: fault injection under a guarded wrapper with
            # graceful RTL→host degradation, scored on the golden vectors.
            resil = None
            if self.resilience is not None:
                with trc.span("workflow.resilience") as sr:
                    resil = self._run_resilience(dep)
                    sr.set_attrs(passed=resil.passed,
                                 detected=resil.detected,
                                 degraded=resil.requests_degraded,
                                 lost=resil.requests_lost)
            rec = WorkflowRecord(
                iteration=it, knobs=dict(knobs), design=design,
                synthesis=syn, measurement=meas,
                est_vs_meas=compare(syn, meas), satisfied=False,
                conformance=conf, resilience=resil, analysis=analysis)
        self.history.append(rec)
        return rec

    def _run_resilience(self, dep):
        """Run the configured :class:`~repro_torch.resilience.ChaosSpec`
        against the deployed artifact (see :func:`chaos_fallback`)."""
        from repro_torch.resilience import run_chaos

        if getattr(dep, "graph", None) is None:
            raise ValueError(
                "Workflow(resilience=...) needs a graph-carrying deployment"
                " (a self-executing target such as 'rtl') to generate "
                "golden vectors and a host fallback of the same design; "
                f"target {self.target!r} produced none")
        return run_chaos(dep, self.resilience,
                         fallback=chaos_fallback(dep, self.creator.hw))

    def _with_analyze(self, options: TargetOptions) -> TargetOptions:
        """Force the workflow's ``analyze`` gate into the target options.
        ``"off"`` is a universal no-op; asking a target whose options have
        no ``analyze`` field to gate raises, so a knob that silently does
        nothing can't pass CI."""
        if not any(f.name == "analyze"
                   for f in dataclasses.fields(options)):
            if self.analyze == "off":
                return options
            raise ValueError(
                f"Workflow(analyze={self.analyze!r}): target "
                f"{self.target!r} options {type(options).__name__} have "
                "no 'analyze' field — only graph-lowering targets "
                "support the static-verifier gate")
        return dataclasses.replace(options, analyze=self.analyze)

    def _synth_from_fn(self, fn, args, model_flops, *, model: str = "wf",
                       arch: Optional[str] = None
                       ) -> Tuple[SynthesisReport, StepCost]:
        """Stage 2 of a step function with no stepper: count one call of
        ``fn(*args)`` on its real arguments, run as stage 3 runs it (under
        ``torch.inference_mode()``), and report it on the Creator's
        HWSpec; ``fits`` reads the intermediates' peak alone."""
        arch = arch or model                 # attribute history to the model
        trc = get_tracer()
        t0 = time.perf_counter()             # monotonic: this is a duration
        with trc.span("xla.lower", arch=arch, kind="step_fn"):
            with torch.inference_mode():
                cost = count_step(fn, args)
        with trc.span("xla.compile", arch=arch, kind="step_fn"):
            hw = self.creator.hw
            rep = roofline(arch=arch, shape="wf", mesh="1dev", n_devices=1,
                           cost=cost.cost_analysis(),
                           hlo_text=cost.as_text(),
                           model_flops=model_flops, hw=hw)
            ch = channel_report(cost.work, cost.op_counts, hw)
        dt = time.perf_counter() - t0
        est_latency = max(rep.step_s, 1e-12)
        est_energy = ch.total_joules + hw.idle_w * est_latency
        syn = SynthesisReport(
            model=model, target=hw.name,
            argument_bytes=cost.argument_bytes,
            output_bytes=cost.output_bytes, temp_bytes=cost.temp_bytes,
            fits=cost.temp_bytes <= hw.hbm_bytes,
            utilization=cost.temp_bytes / hw.hbm_bytes,
            flops=rep.flops_per_device,
            bytes_accessed=rep.bytes_per_device,
            wire_bytes=rep.wire_bytes_per_device,
            est_latency_s=est_latency,
            est_power_w=est_energy / est_latency,
            est_energy_j=est_energy,
            est_gop_per_j=(model_flops / 1e9) / est_energy if est_energy else 0,
            bottleneck=rep.bottleneck, channels=ch.seconds,
            channel_joules=ch.joules, compile_seconds=dt)
        return syn, cost

    def run(self, requirement: Requirement,
            optimizer: Callable[[List[WorkflowRecord]],
                                Optional[Dict[str, Any]]],
            initial_knobs: Dict[str, Any], max_iters: int = 8
            ) -> List[WorkflowRecord]:
        """The feedback loop: tweak → retrain → retranslate → remeasure."""
        knobs = dict(initial_knobs)
        for it in range(max_iters):
            rec = self.run_once(knobs, it)
            rec.satisfied = requirement.satisfied(rec.design, rec.measurement)
            if rec.satisfied:
                break
            nxt = optimizer(self.history)
            if nxt is None:
                break
            knobs = nxt
        return self.history
