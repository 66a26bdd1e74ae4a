"""Fault tolerance: guarded deployments — retry, timeout, circuit breaker,
canary health checks, graceful degradation (DESIGN.md §12; port of
``repro/resilience/guard.py``).

A fleet of accelerators is only viable if one of them can fail, be
*detected* failing, and be routed around without the workload going dark.
:class:`GuardedDeployment` wraps any
:class:`~repro_torch.core.target.Deployment` with the standard guards:

* **per-call timeout** — cooperative: the call runs to completion (the
  devices of every tensor in its answer synchronised, so a wall clock
  counts the card's time too), but a call whose (injectable) clock time
  exceeds ``timeout_s`` is counted a failure and its result discarded
  (the emulator proxy cannot be preempted mid-dispatch; real hardware
  would be power-cycled);
* **bounded retry** — up to ``max_retries`` re-attempts with exponential
  backoff (``backoff_base_s · backoff_mult^attempt``) plus deterministic
  jitter from an injected ``numpy.random.Generator`` — no wall clock and
  no global RNG anywhere in the path, so tests replay exactly;
* **circuit breaker** — the classic closed → open → half-open machine
  per deployment: ``breaker_threshold`` consecutive failures open it,
  ``breaker_cooldown_s`` later one half-open probe is admitted, and
  ``half_open_probes`` successes close it again. A *canary-tripped*
  breaker is quarantined: corrupted memory does not heal by waiting, so
  ``allow()`` stays False until an explicit :meth:`CircuitBreaker.reset`;
* **canary health checks** — every ``canary_every`` calls the guard
  replays a small slice of the design's golden
  :class:`~repro_torch.verify.vectors.VectorSet` through the primary
  (:func:`repro_torch.verify.canary_check`) and demands integer-exact
  responses; a mismatch is a *detected silent fault*: the breaker trips,
  the deployment is quarantined, and traffic fails over;
* **graceful degradation** — a :class:`FallbackPolicy` names ordered
  alternates; the canonical chain is the RTL accelerator failing over to
  the host deployment of the same model (the target registered as
  ``"xla"``, same SynthesisReport lineage): the workload keeps serving,
  flagged ``degraded`` (host-class energy, float instead of fixed-point
  accuracy) instead of going dark.

Every retry/trip/probe/fallback emits ``resilience.*`` counters into the
guard's :class:`~repro_torch.obs.MetricsRegistry` and (when a tracer is
enabled) ``resilience.*`` spans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.target import Deployment
from repro_torch.model.layers import tree_leaves
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.resilience.faults import VirtualClock  # noqa: F401

#: breaker states (DESIGN.md §12 state machine)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def _block_until_ready(out) -> None:
    """Wait for the devices of every tensor in ``out`` (a CUDA call
    returns before its work is done)."""
    devices = {leaf.device for leaf in tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class GuardExhausted(RuntimeError):
    """The primary is unavailable and every fallback failed (or none is
    configured) — the request is lost."""


@dataclass(frozen=True)
class GuardPolicy:
    """The guard's knobs, one validated frozen dataclass (mirrors the
    options-dataclass idiom of the target registry)."""

    timeout_s: float = float("inf")
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_mult: float = 2.0
    jitter_frac: float = 0.1
    breaker_threshold: int = 3       # consecutive failures -> open
    breaker_cooldown_s: float = 1.0  # open -> half-open after this long
    half_open_probes: int = 1        # successes in half-open -> closed
    canary_every: int = 0            # probe every N calls (0 = off)
    canary_slice: int = 4            # golden rows replayed per probe

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1, "
                             f"got {self.backoff_mult}")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1), "
                             f"got {self.jitter_frac}")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1, "
                             f"got {self.breaker_threshold}")
        if self.half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1, "
                             f"got {self.half_open_probes}")
        if self.canary_every < 0 or self.canary_slice < 1:
            raise ValueError("canary_every must be >= 0 and canary_slice "
                             ">= 1")


class CircuitBreaker:
    """Per-deployment closed → open → half-open state machine.

    All transitions go through one place (``_transition``) so each emits
    its ``resilience.breaker.<state>`` counter exactly once; ``trips``
    counts closed/half-open → open edges. Time comes from the injected
    callable clock — a :class:`VirtualClock` under test.
    """

    def __init__(self, policy: GuardPolicy, *, clock=time.perf_counter,
                 name: str = "primary", metrics=None):
        self.policy = policy
        self.clock = clock
        self.name = name
        self.metrics = metrics if metrics is not None else get_metrics()
        self.state = CLOSED
        self.failures = 0                # consecutive
        self.probes = 0                  # half-open successes so far
        self.opened_at: Optional[float] = None
        self.trips = 0
        self.quarantined = False

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        self.metrics.counter(f"resilience.breaker.{state}").inc()
        if state == OPEN:
            self.trips += 1
            self.opened_at = self.clock()

    def allow(self) -> bool:
        """May a primary call be attempted now? An expired cooldown turns
        OPEN into HALF_OPEN (and admits the probe); quarantine never
        expires on its own."""
        if self.quarantined:
            return False
        if self.state == OPEN:
            if self.clock() - self.opened_at >= self.policy.breaker_cooldown_s:
                self.probes = 0
                self._transition(HALF_OPEN)
                return True
            return False
        return True

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self.probes += 1
            if self.probes >= self.policy.half_open_probes:
                self.failures = 0
                self._transition(CLOSED)
        else:
            self.failures = 0

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:      # a failed probe re-opens at once
            self._transition(OPEN)
            return
        self.failures += 1
        if self.failures >= self.policy.breaker_threshold:
            self._transition(OPEN)

    def trip(self, *, quarantine: bool = False) -> None:
        """Force open — e.g. a canary just proved silent corruption.
        ``quarantine=True`` pins it open (no half-open probes) until
        :meth:`reset`."""
        self.quarantined = self.quarantined or quarantine
        self._transition(OPEN)

    def reset(self) -> None:
        """Operator action: reflash/replace happened, start trusting again."""
        self.quarantined = False
        self.failures = 0
        self.probes = 0
        self._transition(CLOSED)


@dataclass
class GuardResult:
    """What one guarded call actually did — the value plus its provenance
    (which substrate answered, degraded or not, how many retries it took)."""

    value: Any
    source: str                      # guard name, or the fallback's name
    degraded: bool = False
    retries: int = 0
    latency_s: float = 0.0
    canary_ran: bool = False
    canary_passed: Optional[bool] = None


@dataclass(frozen=True)
class FallbackPolicy:
    """Ordered graceful degradation: ``alternates`` are ``(name,
    deployment)`` pairs tried in order once the primary is unavailable.
    The canonical chain degrades the RTL accelerator to the host
    deployment of the same model (the ``"xla"`` target's name, kept) —
    same SynthesisReport lineage, flagged accuracy and energy downgrade,
    but the workload keeps serving."""

    alternates: Tuple[Tuple[str, Deployment], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "alternates", tuple(self.alternates))

    @staticmethod
    def to_xla(dep: Deployment, name: str = "xla") -> "FallbackPolicy":
        return FallbackPolicy(alternates=((name, dep),))

    def __bool__(self) -> bool:
        return bool(self.alternates)


class GuardedDeployment(Deployment):
    """The fault-tolerant wrapper every pooled deployment serves behind.

    :meth:`call` is the full-fidelity entry (returns a
    :class:`GuardResult`); ``__call__`` keeps the uniform Deployment
    contract (returns the value, raises :class:`GuardExhausted` when the
    request is lost). ``measure``/``save``/``verify`` delegate to the
    primary — guarding changes who answers, not what the artifact is.
    """

    def __init__(self, primary: Deployment, *,
                 policy: GuardPolicy = GuardPolicy(),
                 fallback=None, canary=None,
                 clock=time.perf_counter, sleep=None, rng=None,
                 metrics=None, name: str = "primary"):
        self.primary = primary
        self.policy = policy
        if fallback is not None and not isinstance(fallback, FallbackPolicy):
            fallback = FallbackPolicy.to_xla(fallback)
        self.fallback = fallback
        self.canary_vectors = canary     # a golden VectorSet (or None)
        self.clock = clock
        # sleeps are injectable for determinism; a VirtualClock brings its
        # own (advancing virtual time), wall clocks get time.sleep
        self.sleep = sleep if sleep is not None else (
            clock.sleep if hasattr(clock, "sleep") else time.sleep)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.metrics = metrics if metrics is not None else get_metrics()
        self.name = name
        self.breaker = CircuitBreaker(policy, clock=clock, name=name,
                                      metrics=self.metrics)
        self.calls = 0
        self.detections: List[dict] = []

    # -- Deployment contract -------------------------------------------- #
    @property
    def target(self):
        return self.primary.target

    @property
    def graph(self):
        return getattr(self.primary, "graph", None)

    @property
    def emulator(self):
        return getattr(self.primary, "emulator", None)

    @property
    def cycles(self):
        return self.primary.cycles

    def measure(self, args, **kw):
        return self.primary.measure(args, **kw)

    def save(self, build_dir: str) -> None:
        self.primary.save(build_dir)

    @property
    def quarantined(self) -> bool:
        return self.breaker.quarantined

    # -- health --------------------------------------------------------- #
    def probe(self) -> Optional[bool]:
        """Run the canary now: replay ``canary_slice`` golden rows through
        the primary and demand integer-exact responses. A mismatch is a
        detected silent fault — counter, detection log entry, breaker
        tripped with quarantine. Returns the verdict (None without a
        canary set)."""
        if self.canary_vectors is None:
            return None
        from repro_torch.verify import canary_check

        trc = get_tracer()
        with trc.span("resilience.canary", guard=self.name,
                      n=self.policy.canary_slice):
            res = canary_check(self.primary, self.canary_vectors,
                               n=self.policy.canary_slice)
        self.metrics.counter("resilience.canary_probes").inc()
        if not res.passed:
            self.metrics.counter("resilience.faults_detected").inc()
            self.detections.append({"call": self.calls,
                                    "n_mismatch": res.n_mismatch,
                                    "max_diff": res.max_diff})
            self.breaker.trip(quarantine=True)
        return res.passed

    def can_serve(self) -> bool:
        """Health-aware admission: will a request routed here get *an*
        answer? True when the primary is admissible (or will be after its
        cooldown check in ``allow``), or when a fallback stands behind it."""
        if self.fallback:
            return True
        b = self.breaker
        if b.quarantined:
            return False
        if b.state == OPEN:
            return (self.clock() - b.opened_at
                    >= self.policy.breaker_cooldown_s)
        return True

    def health(self) -> dict:
        return {"name": self.name, "state": self.breaker.state,
                "quarantined": self.breaker.quarantined,
                "consecutive_failures": self.breaker.failures,
                "trips": self.breaker.trips, "calls": self.calls,
                "detections": len(self.detections),
                "has_fallback": bool(self.fallback)}

    # -- the guarded call ----------------------------------------------- #
    def _backoff(self, attempt: int) -> float:
        base = self.policy.backoff_base_s * self.policy.backoff_mult ** attempt
        jitter = self.policy.jitter_frac * (2.0 * self.rng.random() - 1.0)
        return base * (1.0 + jitter)

    def _attempt_primary(self, args) -> Tuple[bool, Any]:
        t0 = self.clock()
        try:
            out = self.primary(*args)
            _block_until_ready(out)
        except Exception:                # noqa: BLE001 - any call failure
            self.metrics.counter("resilience.primary_errors").inc()
            return False, None
        if self.clock() - t0 > self.policy.timeout_s:
            self.metrics.counter("resilience.timeouts").inc()
            return False, None
        return True, out

    def call(self, *args) -> GuardResult:
        """One guarded request. Canary (if due) → primary with
        retry/timeout under the breaker → fallback chain → lost."""
        tick = self.calls
        self.calls += 1
        trc = get_tracer()
        canary_ran, canary_passed = False, None
        if (self.canary_vectors is not None and self.policy.canary_every > 0
                and tick % self.policy.canary_every == 0
                and not self.breaker.quarantined):
            canary_passed = self.probe()
            canary_ran = True
        t_start = self.clock()
        retries = 0
        if self.breaker.allow():
            # a half-open breaker admits exactly one probe call, no retries
            attempts = 1 if self.breaker.state == HALF_OPEN \
                else self.policy.max_retries + 1
            for attempt in range(attempts):
                ok, out = self._attempt_primary(args)
                if ok:
                    self.breaker.record_success()
                    self.metrics.counter("resilience.calls.primary").inc()
                    return GuardResult(value=out, source=self.name,
                                       degraded=False, retries=retries,
                                       latency_s=self.clock() - t_start,
                                       canary_ran=canary_ran,
                                       canary_passed=canary_passed)
                self.breaker.record_failure()
                if attempt + 1 < attempts:
                    retries += 1
                    self.metrics.counter("resilience.retries").inc()
                    delay = self._backoff(attempt)
                    if trc.enabled:
                        with trc.span("resilience.backoff", attempt=attempt,
                                      delay_s=delay):
                            self.sleep(delay)
                    else:
                        self.sleep(delay)
        # primary unavailable (breaker open/quarantined or retries spent):
        # degrade down the fallback chain
        if self.fallback:
            for fname, fdep in self.fallback.alternates:
                try:
                    with trc.span("resilience.fallback", to=fname):
                        out = fdep(*args)
                    self.metrics.counter("resilience.fallbacks").inc()
                    self.metrics.counter(
                        f"resilience.calls.{fname}").inc()
                    return GuardResult(value=out, source=fname,
                                       degraded=True, retries=retries,
                                       latency_s=self.clock() - t_start,
                                       canary_ran=canary_ran,
                                       canary_passed=canary_passed)
                except Exception:        # noqa: BLE001 - try the next one
                    self.metrics.counter("resilience.fallback_errors").inc()
        self.metrics.counter("resilience.requests_lost").inc()
        raise GuardExhausted(
            f"guarded deployment {self.name!r}: primary unavailable "
            f"(breaker {self.breaker.state}"
            f"{', quarantined' if self.breaker.quarantined else ''}, "
            f"{retries} retries) and no fallback answered")

    def __call__(self, *args):
        return self.call(*args).value
