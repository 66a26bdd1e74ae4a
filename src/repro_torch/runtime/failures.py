"""Failure injection — how we test fault tolerance without a cluster
(port of ``repro/runtime/failures.py``; numpy only).

``FailureInjector`` raises :class:`PreemptionError` at configured steps
(deterministically or with a seeded probability), standing in for SIGTERM
preemptions / ICI link flaps / host OOMs. The trainer must recover from any
of these by restoring the last checkpoint and replaying the data stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Set

import numpy as np


class PreemptionError(RuntimeError):
    """A node went away (SIGTERM / hardware fault)."""


class StragglerWarning(RuntimeWarning):
    """A step exceeded the straggler threshold."""


@dataclass
class FailureInjector:
    fail_at_steps: Set[int] = field(default_factory=set)
    fail_prob: float = 0.0
    seed: int = 0
    max_failures: int = 10
    _rng: Optional[np.random.Generator] = None
    _count: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def maybe_fail(self, step: int) -> None:
        if self._count >= self.max_failures:
            return
        if step in self.fail_at_steps:
            self.fail_at_steps = self.fail_at_steps - {step}  # fire once
            self._count += 1
            raise PreemptionError(f"injected preemption at step {step}")
        if self.fail_prob > 0 and self._rng.random() < self.fail_prob:
            self._count += 1
            raise PreemptionError(f"injected preemption at step {step}")
