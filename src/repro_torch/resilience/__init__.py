"""Fault injection & fault-tolerant deployment (DESIGN.md §12; port of
``repro/resilience``).

The Elastic Node verifies an accelerator once, at bring-up; pervasive
deployments then run it unattended in the field, where SEU bit-flips,
stalls and transient failures arrive uninvited. This package makes both
halves of that story first-class over the uniform ``Deployment`` API:

* :mod:`repro_torch.resilience.faults` — deterministic, seeded chaos:
  :class:`FaultPlan` scripts (JSON artifacts) injected by
  :class:`FaultyDeployment` — SEU bit-flips in the RTL emulator's prepared
  device memories, stuck-at outputs, latency spikes on an injectable
  :class:`VirtualClock`, raised :class:`TransientFault` s;
* :mod:`repro_torch.resilience.guard` — :class:`GuardedDeployment`: per-call
  timeout, bounded retry with deterministic-jitter backoff, a
  closed→open→half-open :class:`CircuitBreaker`, golden-vector canary
  probes that detect *silent* corruption and quarantine, and a
  :class:`FallbackPolicy` degrading RTL→host (the ``"xla"`` target) so
  the workload keeps serving;
* :mod:`repro_torch.resilience.chaos` — :func:`run_chaos` scores a scripted
  scenario against the golden vectors into a :class:`ResilienceReport`
  (injected/detected/recovered, corrupted-after-detection, MTTR).

Every retry/trip/probe/fallback emits ``resilience.*`` counters and spans
through :mod:`repro_torch.obs`; every random choice and every clock is injected,
so scenarios replay run-twice-identical.
"""
from repro_torch.resilience.chaos import (  # noqa: F401
    ChaosSpec, ResilienceReport, run_chaos)
from repro_torch.resilience.faults import (  # noqa: F401
    FAULT_KINDS, SILENT_KINDS, FaultPlan, FaultSpec, FaultyDeployment,
    TransientFault, VirtualClock)
from repro_torch.resilience.guard import (  # noqa: F401
    CLOSED, HALF_OPEN, OPEN, CircuitBreaker, FallbackPolicy,
    GuardedDeployment, GuardExhausted, GuardPolicy, GuardResult)

__all__ = [
    "FAULT_KINDS", "SILENT_KINDS", "FaultSpec", "FaultPlan",
    "FaultyDeployment", "TransientFault", "VirtualClock",
    "CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker", "GuardPolicy",
    "GuardedDeployment", "GuardResult", "FallbackPolicy", "GuardExhausted",
    "ChaosSpec", "ResilienceReport", "run_chaos",
]
