"""Program-cache affinity routing across a pool of deployments (port of
``repro/serving/router.py``).

Every pool member owns its own staged executor, and each executor builds
one program per ``(batch shape, dtype)`` into a small LRU (DESIGN.md §7).
At fleet scale the dominant avoidable cost is *rebuilding*: dispatching a
shape to a member that has never seen it pays a program build (on CUDA an
eager warm-up and a CUDA Graph capture), while the member one slot over
already holds the program. The router therefore
routes each packed batch to the member whose compiled-program LRU already
holds that shape key (an **affinity hit**), and only falls back to
health-aware round-robin (the ``can_serve`` contract) on a miss — so
steady mixed traffic converges to a stable shape→member assignment and
``RTLEmulator.trace_count`` stops growing.

Members are duck-typed exactly like :class:`~repro_torch.serving.pool`
members: ``can_serve()`` gates admission when present (a guarded
deployment's health gate), ``holds_program(shape,
dtype)`` answers affinity when present, else the member's ``.emulator``
(:meth:`~repro_torch.rtl.emulator.RTLEmulator.has_program`) is consulted; plain
callables serve unconditionally with no affinity.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.obs import MetricsRegistry, get_metrics


class NoServeableMember(RuntimeError):
    """Every member of the pool is quarantined/open with no fallback."""


def member_holds_program(member, shape, dtype) -> bool:
    """Does ``member`` already hold a compiled program for this key?"""
    holds = getattr(member, "holds_program", None)
    if holds is not None:
        return bool(holds(shape, dtype))
    emu = getattr(member, "emulator", None)
    if emu is not None and hasattr(emu, "has_program"):
        return bool(emu.has_program(shape, dtype))
    return False


class AffinityRouter:
    """Pick a pool member per dispatch: affinity first, health always."""

    def __init__(self, members, *, name: str = "serving.router",
                 metrics: Optional[MetricsRegistry] = None):
        if not members:
            raise ValueError("AffinityRouter needs at least one member")
        self.members = list(members)
        self.name = name
        self._metrics = metrics
        self._rr = 0

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics if self._metrics is not None else get_metrics()

    def serveable(self, exclude: Tuple[int, ...] = ()) -> List[int]:
        """Indices of members whose ``can_serve()`` admits traffic now."""
        return [i for i, m in enumerate(self.members)
                if i not in exclude
                and (not hasattr(m, "can_serve") or m.can_serve())]

    def route(self, shape=None, dtype=None, *,
              exclude: Tuple[int, ...] = ()) -> Tuple[int, object, bool]:
        """Returns ``(index, member, affinity_hit)`` for one dispatch.

        ``shape``/``dtype`` key the affinity lookup (omit them for
        shapeless work — pure health-aware round-robin). ``exclude`` skips
        members that already failed this request (redispatch).
        """
        healthy = self.serveable(exclude)
        if not healthy:
            raise NoServeableMember(
                f"{self.name}: no serveable member among "
                f"{len(self.members)} (excluded: {list(exclude)})")
        if shape is not None:
            shape = tuple(int(d) for d in shape)
            for i in healthy:
                if member_holds_program(self.members[i], shape, dtype):
                    self.metrics.counter(f"{self.name}.affinity_hit").inc()
                    return i, self.members[i], True
            self.metrics.counter(f"{self.name}.affinity_miss").inc()
        i = healthy[self._rr % len(healthy)]
        self._rr += 1
        return i, self.members[i], False
