"""Deterministic fault injection — the chaos half of the resilience layer
(port of ``repro/resilience/faults.py``).

The Elastic Node's one-shot verification pass proves an accelerator was
correct *when flashed*; pervasive deployments then leave it in the field,
where embedded FPGAs take single-event upsets (SEUs) in BRAM/LUT memories,
transient link failures, and latency stalls that no bring-up check ever
sees (Venieris et al. 2018 make in-field reliability a first-class
deployment constraint). This module makes those faults a *scripted,
seeded, replayable* input to the toolchain:

* :class:`FaultSpec` / :class:`FaultPlan` — one fault = kind × trigger
  (exact call index or seeded per-call probability) × kind parameters,
  JSON round-trippable so a chaos scenario is a checked-in artifact;
* :class:`FaultyDeployment` — wraps any
  :class:`~repro_torch.core.target.Deployment` and injects the plan on each
  call: ``bitflip`` flips one bit of one word of an RTL deployment's
  prepared device memories (the SEU model, via
  :meth:`~repro_torch.rtl.emulator.RTLEmulator.flip_bit` — *silent*: subsequent
  outputs are wrong with no error raised), ``stuck_output`` forces every
  output element to a constant (a wedged output register; a tensor answer
  stays a tensor on its device), ``latency``
  injects a stall (advancing the injectable clock, so guarded timeouts
  see it deterministically), and ``transient`` raises
  :class:`TransientFault` (a flaked call that a retry may heal).

Determinism is the same contract as the golden vectors: every random
choice (probabilistic triggers, seeded memory/word selection) comes from
one ``numpy`` PCG64 stream keyed by ``FaultPlan.seed``, and time is a
:class:`VirtualClock` under test — the same plan against the same design
injects the same faults at the same calls, twice (tested), and the same
faults as the reference's draws from the same seed.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.target import Deployment
from repro_torch.model.layers import tree_map
from repro_torch.obs import get_metrics, get_tracer

#: the fault taxonomy (DESIGN.md §12): silent memory corruption, wedged
#: outputs, stalls, and flaked calls.
FAULT_KINDS = ("bitflip", "stuck_output", "latency", "transient")
#: the kinds that corrupt *responses without raising* — only a canary
#: (golden-vector replay) can detect them.
SILENT_KINDS = ("bitflip", "stuck_output")


def _stuck(a, value: float):
    """``a`` with every element ``value``: a tensor on its own device, an
    array or a scalar as an array."""
    if isinstance(a, torch.Tensor):
        return torch.full_like(a, value)
    return np.full_like(np.asarray(a), value)


class TransientFault(RuntimeError):
    """An injected transient call failure (link flap, brown-out, ...)."""


class VirtualClock:
    """Deterministic time: ``now()``/calling it reads accumulated virtual
    seconds, ``sleep``/``advance`` moves it forward. Inject wherever a wall
    clock would make a retry/backoff/breaker/timeout test flaky — the whole
    resilience layer takes its clock (and its sleeps) from outside."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def __call__(self) -> float:         # usable directly as a clock fn
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, float(dt))

    advance = sleep


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: what kind, when it fires, and its parameters.

    Triggers: ``at_call`` pins the fault to an exact 0-based call index of
    the wrapped deployment; otherwise each call draws
    ``Bernoulli(probability)`` from the plan's seeded stream. ``once``
    disarms the spec after its first firing (an SEU happens once; a noisy
    link flaps repeatedly — set ``once=False``).
    """

    kind: str
    at_call: Optional[int] = None
    probability: float = 0.0
    once: bool = True
    # -- bitflip (SEU) parameters ------------------------------------- #
    memory: Optional[str] = None     # "node.key" of the prepared memory;
    #                                  None = seeded choice over all
    word: Optional[int] = None       # flat word index; None = seeded
    bit: int = 0                     # bit position within the int32 word
    # -- stuck_output ---------------------------------------------------#
    value: float = 0.0               # every output element forced to this
    # -- latency --------------------------------------------------------#
    delay_s: float = 0.0             # injected stall

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"FaultSpec.kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1], "
                             f"got {self.probability}")
        if self.at_call is None and self.probability == 0.0:
            raise ValueError(f"FaultSpec({self.kind!r}) never fires: give "
                             "at_call or probability > 0")
        if not 0 <= self.bit <= 31:
            raise ValueError(f"bit must be in [0, 31], got {self.bit}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclass(frozen=True)
class FaultPlan:
    """A scripted chaos scenario: an ordered tuple of specs + the seed that
    drives every probabilistic trigger and seeded memory/word choice.
    JSON round-trippable (``to_json``/``from_json``/``save``/``load``) so a
    scenario is a reviewable, checked-in artifact
    (``examples/chaos_plan.json``, the CI chaos smoke)."""

    faults: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [asdict(f) for f in self.faults]},
            indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        doc = json.loads(text)
        return FaultPlan(faults=tuple(FaultSpec(**f)
                                      for f in doc.get("faults", ())),
                         seed=int(doc.get("seed", 0)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_json(f.read())


class FaultyDeployment(Deployment):
    """Injects a :class:`FaultPlan` into any wrapped Deployment.

    Sits *under* a :class:`~repro_torch.resilience.guard.GuardedDeployment` in a
    chaos scenario: the guard sees exactly what a flaky accelerator would
    show it — slow calls, raised transients, and (for the silent kinds)
    wrong answers with no exception. Call indices count raw invocations of
    this wrapper (retries included), which is what a per-call fault model
    means on real hardware.

    ``injected`` keeps a structured log of every firing (call index, kind,
    and the resolved bitflip address) — the evidence half of the
    :class:`~repro_torch.resilience.chaos.ResilienceReport`.
    """

    def __init__(self, dep: Deployment, plan: FaultPlan, *,
                 clock: Optional[VirtualClock] = None, metrics=None):
        self.inner = dep
        self.plan = plan
        self.clock = clock
        self.metrics = metrics if metrics is not None else get_metrics()
        self._rng = np.random.Generator(np.random.PCG64(plan.seed))
        self._armed: List[FaultSpec] = list(plan.faults)
        self.calls = 0
        self.injected: List[Dict] = []

    # -- Deployment proxying ------------------------------------------- #
    @property
    def target(self):                    # noqa: D401 - metadata proxy
        return self.inner.target

    @property
    def graph(self):
        return getattr(self.inner, "graph", None)

    @property
    def emulator(self):
        return getattr(self.inner, "emulator", None)

    @property
    def cycles(self):
        return self.inner.cycles

    def measure(self, args, **kw):
        return self.inner.measure(args, **kw)

    def save(self, build_dir: str) -> None:
        self.inner.save(build_dir)

    # -- injection ------------------------------------------------------ #
    def _fires(self, spec: FaultSpec, call: int) -> bool:
        if spec.at_call is not None:
            return call == spec.at_call
        return self._rng.random() < spec.probability

    def _record(self, spec: FaultSpec, call: int, **detail) -> None:
        self.metrics.counter("resilience.faults_injected").inc()
        self.metrics.counter(f"resilience.faults_injected.{spec.kind}").inc()
        self.injected.append({"call": call, "kind": spec.kind, **detail})

    def _flip(self, spec: FaultSpec, call: int) -> None:
        emu = self.emulator
        if emu is None:
            raise ValueError(
                "bitflip faults model SEUs in prepared device memories; the "
                f"wrapped deployment (target {self.inner.target!r}) carries "
                "no RTL emulator")
        mems = emu.memories()
        if spec.memory is not None:
            node, _, key = spec.memory.rpartition(".")
            if (node, key) not in mems:
                raise ValueError(
                    f"unknown memory {spec.memory!r}; addressable memories: "
                    f"{['.'.join(m) for m in mems]}")
        else:
            node, key = mems[int(self._rng.integers(len(mems)))]
        size = int(emu.prepared(node)[key].numel())
        word = int(spec.word) if spec.word is not None \
            else int(self._rng.integers(size))
        new = emu.flip_bit(node, key, word, spec.bit)
        self._record(spec, call, memory=f"{node}.{key}", word=word % size,
                     bit=spec.bit, new_word=new)

    def __call__(self, *args):
        call = self.calls
        self.calls += 1
        fired = [s for s in self._armed if self._fires(s, call)]
        for s in fired:
            if s.once:
                self._armed.remove(s)
        trc = get_tracer()
        for s in fired:
            if trc.enabled:
                with trc.span("resilience.inject", kind=s.kind, call=call):
                    pass
            if s.kind == "latency":
                self._record(s, call, delay_s=s.delay_s)
                if self.clock is not None:
                    self.clock.advance(s.delay_s)
                else:
                    time.sleep(s.delay_s)
            elif s.kind == "bitflip":
                self._flip(s, call)
            elif s.kind == "transient":
                self._record(s, call)
                raise TransientFault("injected transient fault at call "
                                     f"{call}")
        out = self.inner(*args)
        for s in fired:
            if s.kind == "stuck_output":
                self._record(s, call, value=s.value)
                out = tree_map(lambda a, v=s.value: _stuck(a, v), out)
        return out
