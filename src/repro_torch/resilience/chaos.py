"""Scripted chaos scenarios → :class:`ResilienceReport` (port of
``repro/resilience/chaos.py``).

:func:`run_chaos` is the acceptance harness for the resilience layer: it
stacks a :class:`~repro_torch.resilience.faults.FaultyDeployment`
(injecting a seeded :class:`~repro_torch.resilience.faults.FaultPlan`)
under a :class:`~repro_torch.resilience.guard.GuardedDeployment` (canary +
breaker + retry + RTL→host fallback), drives a fixed request sequence drawn
from the design's golden :class:`~repro_torch.verify.vectors.VectorSet`,
and scores every
response against the golden codes. Because the stimulus doubles as the
ground truth, the report can say not just "requests served" but *"zero
corrupted responses after detection"* — the claim that matters for a
fleet.

Everything is deterministic: one internal :class:`VirtualClock` shared by
injector and guard, numpy PCG64 streams keyed by the plan/spec seeds, and
a fresh :class:`~repro_torch.obs.MetricsRegistry` per run — the same
scenario run twice yields byte-identical ``ResilienceReport.to_json()``
(tested, mirroring the emit-twice golden-artifact contract), and so does
the same scenario in the reference and in the port, on the CPU or on the
card. Answers come to the host before they are scored.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.target import Deployment
from repro_torch.obs import MetricsRegistry, get_tracer
from repro_torch.resilience.faults import (FaultPlan, FaultyDeployment,
                                           VirtualClock)
from repro_torch.resilience.guard import (FallbackPolicy, GuardedDeployment,
                                          GuardExhausted, GuardPolicy)
from repro_torch.verify.conformance import _host


@dataclass(frozen=True)
class ChaosSpec:
    """One scripted scenario: the fault plan, how many requests to drive,
    and the guard policy under test."""

    plan: FaultPlan
    n_requests: int = 32
    policy: GuardPolicy = field(default_factory=lambda: GuardPolicy(
        timeout_s=0.25, max_retries=2, backoff_base_s=0.01,
        breaker_threshold=3, breaker_cooldown_s=1.0, canary_every=4))
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1, "
                             f"got {self.n_requests}")


@dataclass
class ResilienceReport:
    """The structured outcome of one chaos scenario — what was injected,
    what the guard detected, and what the workload actually experienced.

    ``mttr_requests`` is mean-time-to-recover in request ticks: from the
    first *silent* injection to the first detection (canary trip). -1 when
    nothing silent was injected or nothing was detected.
    """

    design: str
    target: str
    n_requests: int
    seed: int
    faults_injected: List[Dict] = field(default_factory=list)
    faults_detected: List[Dict] = field(default_factory=list)
    detected: bool = False
    recovered: bool = False            # served degraded after detection
    requests_ok: int = 0               # primary-served, response correct
    requests_degraded: int = 0         # fallback-served
    requests_corrupted: int = 0        # served but wrong vs golden codes
    corrupted_after_detection: int = 0
    requests_lost: int = 0             # GuardExhausted
    retries: int = 0
    fallbacks: int = 0
    breaker_trips: int = 0
    mttr_requests: int = -1
    final_breaker_state: str = "closed"
    counters: Dict[str, int] = field(default_factory=dict)
    requests: List[Dict] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        """The acceptance bar: silent fault detected, traffic kept
        flowing degraded, and zero corrupted responses after detection."""
        return (self.detected and self.recovered
                and self.corrupted_after_detection == 0)

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        d["passed"] = self.passed
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    def summary(self) -> str:
        return (f"chaos[{self.design}/{self.target}] "
                f"{self.n_requests} requests: "
                f"{len(self.faults_injected)} injected / "
                f"{len(self.faults_detected)} detected "
                f"(mttr {self.mttr_requests} req), "
                f"{self.requests_ok} ok / {self.requests_degraded} degraded "
                f"/ {self.requests_corrupted} corrupted "
                f"({self.corrupted_after_detection} after detection) / "
                f"{self.requests_lost} lost; "
                f"retries {self.retries}, fallbacks {self.fallbacks}, "
                f"breaker {self.final_breaker_state} "
                f"({self.breaker_trips} trips) -> "
                f"{'PASS' if self.passed else 'FAIL'}")


def run_chaos(dep: Deployment, spec: ChaosSpec, *,
              fallback: Optional[FallbackPolicy] = None,
              vectors=None,
              metrics: Optional[MetricsRegistry] = None) -> ResilienceReport:
    """Drive ``spec.n_requests`` golden-vector requests through
    ``dep`` wrapped in fault injection + guarding, and score the result.

    ``vectors`` defaults to the design's generated golden
    :class:`~repro_torch.verify.vectors.VectorSet` (requires a
    graph-carrying deployment; generated on the deployment's device); they
    provide both the stimulus stream (row ``i % n``, singleton batches)
    and the ground truth for corruption scoring.
    """
    graph = getattr(dep, "graph", None)
    if vectors is None:
        if graph is None:
            raise ValueError(
                "run_chaos needs golden vectors to drive and score the "
                f"scenario; deployment (target {dep.target!r}) carries no "
                "graph to generate them from — pass vectors= explicitly")
        from repro_torch.verify import generate_vectors

        vectors = generate_vectors(graph,
                                   device=getattr(dep, "device", None))

    mx = metrics if metrics is not None else MetricsRegistry()
    clock = VirtualClock()
    faulty = FaultyDeployment(dep, spec.plan, clock=clock, metrics=mx)
    guard = GuardedDeployment(
        faulty, policy=spec.policy, fallback=fallback,
        canary=vectors, clock=clock,
        rng=np.random.Generator(np.random.PCG64(spec.seed)), metrics=mx,
        name=f"{vectors.design}:{dep.target}")

    stim_f = np.asarray(vectors.stimulus_f())
    golden = np.asarray(vectors.response)
    scale = float(vectors.out_fmt.scale)
    n_rows = stim_f.shape[0]

    rep = ResilienceReport(design=vectors.design, target=dep.target,
                           n_requests=spec.n_requests, seed=spec.seed)
    trc = get_tracer()
    detected_at = -1
    with trc.span("resilience.chaos", design=vectors.design,
                  n_requests=spec.n_requests):
        for i in range(spec.n_requests):
            row = i % n_rows
            x = stim_f[row][None]
            inj_before = len(faulty.injected)
            det_before = len(guard.detections)
            entry: Dict = {"request": i, "row": row}
            try:
                res = guard.call(x)
            except GuardExhausted:
                rep.requests_lost += 1
                entry["status"] = "lost"
                rep.requests.append(entry)
                continue
            finally:
                for f in faulty.injected[inj_before:]:
                    f.setdefault("request", i)
                if detected_at < 0 and len(guard.detections) > det_before:
                    detected_at = i
            entry.update(source=res.source, degraded=res.degraded,
                         retries=res.retries, canary_ran=res.canary_ran)
            codes = np.rint(_host(res.value) * scale).astype(np.int64)
            correct = bool(np.array_equal(codes.reshape(golden[row].shape),
                                          golden[row]))
            entry["correct"] = correct
            if not correct:
                rep.requests_corrupted += 1
                if detected_at >= 0:
                    rep.corrupted_after_detection += 1
                entry["status"] = "corrupted"
            elif res.degraded:
                entry["status"] = "degraded"
            else:
                entry["status"] = "ok"
            if res.degraded:
                rep.requests_degraded += 1
                if detected_at >= 0 and correct:
                    rep.recovered = True
            elif correct:
                rep.requests_ok += 1
            rep.requests.append(entry)

    rep.faults_injected = list(faulty.injected)
    rep.faults_detected = [dict(d, request=detected_at)
                           for d in guard.detections]
    rep.detected = bool(guard.detections)
    if rep.detected and detected_at >= 0:
        silent = [f.get("request", -1) for f in faulty.injected
                  if f["kind"] in ("bitflip", "stuck_output")]
        first_silent = min((r for r in silent if r >= 0), default=-1)
        if first_silent >= 0:
            rep.mttr_requests = detected_at - first_silent
    rep.retries = int(mx.counter("resilience.retries").value)
    rep.fallbacks = int(mx.counter("resilience.fallbacks").value)
    rep.breaker_trips = guard.breaker.trips
    rep.final_breaker_state = guard.breaker.state
    rep.counters = {k: v["value"] for k, v in mx.snapshot().items()
                    if k.startswith("resilience.") and v["type"] == "counter"}
    return rep
