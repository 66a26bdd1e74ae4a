"""Bounded admission queue with deadlines — the farm's front door (port
of ``repro/serving/queue.py``).

Fleet-scale serving is an *admission* problem before it is a compute
problem: heavy traffic must meet a bounded queue (backpressure, not an
unbounded pile-up), and a request that can no longer meet its deadline must
be shed *before* it wastes a dispatch slot. :class:`AdmissionQueue` is that
contract, shared by the micro-batching farm (:mod:`repro_torch.serving.farm`) and
the health-aware :class:`~repro_torch.serving.pool.DeploymentPool`:

* :meth:`offer` admits a request or sheds it immediately when the queue is
  at capacity (``status="shed"``, ``serving.queue.shed_full``) — the caller
  always learns the outcome synchronously;
* :meth:`expire` walks the queue and sheds every request whose absolute
  ``deadline_s`` has passed on the queue's injectable clock
  (``status="expired"``, ``serving.queue.expired``) — sustained overload
  turns into load-shedding instead of latency creep;
* :meth:`take` hands admitted requests to the scheduler in FIFO order.

Time comes from an injected callable clock (a counter under test), so
deadline behavior replays exactly.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional

from repro_torch.obs import MetricsRegistry, get_metrics

#: request lifecycle states (one-way: queued -> terminal)
QUEUED, DONE, SHED, EXPIRED, FAILED = (
    "queued", "done", "shed", "expired", "failed")


@dataclass
class ServeRequest:
    """One unit of serving work: a window (or opaque payload) for a design.

    ``window`` is a per-request input — for the farm a ``(T, F)`` float
    window; for the generic pool an arbitrary args tuple. Timing fields are
    stamped from the owning component's clock; ``status`` moves exactly
    once from ``queued`` to a terminal state, so "zero dropped after
    admission" is checkable from the request log alone.
    """

    rid: int
    design: str
    window: Any
    t_submit: float = 0.0
    deadline_s: Optional[float] = None   # absolute, on the owner's clock
    status: str = QUEUED
    result: Any = None
    error: Optional[str] = None
    # dispatch provenance (filled by the farm)
    t_done: Optional[float] = None
    member: Optional[int] = None
    bucket_len: Optional[int] = None
    batch_size: Optional[int] = None
    meta: dict = field(default_factory=dict)

    @property
    def terminal(self) -> bool:
        return self.status != QUEUED


class AdmissionQueue:
    """Bounded FIFO with deadline expiry over an injectable clock."""

    def __init__(self, capacity: int, *, clock=time.perf_counter,
                 metrics: Optional[MetricsRegistry] = None,
                 name: str = "serving.queue"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.name = name
        self._metrics = metrics
        self._q: Deque[ServeRequest] = deque()

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics if self._metrics is not None else get_metrics()

    def __len__(self) -> int:
        return len(self._q)

    def _gauge_depth(self) -> None:
        self.metrics.gauge(f"{self.name}.depth").set(len(self._q))

    # -- admission ------------------------------------------------------ #
    def offer(self, req: ServeRequest) -> bool:
        """Admit ``req`` or shed it at the door. Returns admission."""
        if len(self._q) >= self.capacity:
            req.status = SHED
            req.error = "queue_full"
            self.metrics.counter(f"{self.name}.shed_full").inc()
            return False
        req.t_submit = self.clock() if req.t_submit == 0.0 else req.t_submit
        self._q.append(req)
        self.metrics.counter(f"{self.name}.admitted").inc()
        self._gauge_depth()
        return True

    # -- aging ---------------------------------------------------------- #
    def expire(self) -> List[ServeRequest]:
        """Shed every queued request whose deadline has passed; returns
        the expired requests (already marked terminal).

        The comparison is ``now >= deadline``: a deadline is the last
        instant a *response* may land, so a request first inspected
        exactly at its deadline cannot be served in time — dispatching it
        would burn accelerator work on an already-missed SLO.
        """
        now = self.clock()
        expired: List[ServeRequest] = []
        if not self._q:
            return expired
        keep: Deque[ServeRequest] = deque()
        for req in self._q:
            if req.deadline_s is not None and now >= req.deadline_s:
                req.status = EXPIRED
                req.error = "deadline"
                expired.append(req)
                self.metrics.counter(f"{self.name}.expired").inc()
            else:
                keep.append(req)
        self._q = keep
        if expired:
            self._gauge_depth()
        return expired

    # -- scheduling ----------------------------------------------------- #
    def take(self, n: Optional[int] = None) -> List[ServeRequest]:
        """Pop up to ``n`` requests FIFO (all of them when ``n`` is None)."""
        n = len(self._q) if n is None else min(n, len(self._q))
        out = [self._q.popleft() for _ in range(n)]
        if out:
            self._gauge_depth()
        return out

    def peek(self) -> List[ServeRequest]:
        """The queued requests, oldest first, without removing them."""
        return list(self._q)

    def requeue(self, reqs: List[ServeRequest]) -> None:
        """Put not-yet-dispatched requests back at the front, preserving
        FIFO order (used when the batcher leaves a partial batch to
        linger)."""
        for req in reversed(reqs):
            self._q.appendleft(req)
        if reqs:
            self._gauge_depth()

    def oldest_wait_s(self) -> float:
        """Age of the head request on the queue clock (0 when empty)."""
        if not self._q:
            return 0.0
        return max(0.0, self.clock() - self._q[0].t_submit)
