"""Health-aware request pool, rebuilt on the serving primitives (port of
``repro/serving/pool.py``).

This is the ``DeploymentPool`` contract (bounded queue, shed at
submit, tick-based age-out, round-robin across ``can_serve()`` members,
``ok/degraded/lost/shed`` result statuses, ``server.pool.*`` metrics) with
its ad-hoc tick loop replaced by the shared serving machinery:

* admission and aging run through one
  :class:`~repro_torch.serving.queue.AdmissionQueue` driven by a **tick clock**
  (``now == self.ticks``), so ``max_wait_ticks`` is just a deadline on
  that clock;
* member selection runs through an
  :class:`~repro_torch.serving.router.AffinityRouter` (health-aware round-robin;
  this pool dispatches opaque args, so no shape key and no affinity —
  the micro-batching farm is the affinity user).

The canonical drain entrypoint is :meth:`drain`;
``runtime.server.DeploymentPool`` keeps the old constructor and
``run_until_drained`` as thin deprecated shims over this class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.queue import DONE, AdmissionQueue, ServeRequest, SHED
from repro_torch.serving.router import AffinityRouter, NoServeableMember


@dataclass
class PoolStats:
    """What a :class:`DeploymentPool` run actually did."""

    ticks: int = 0
    submitted: int = 0
    served_ok: int = 0
    served_degraded: int = 0
    shed: int = 0
    lost: int = 0
    max_queue_depth: int = 0


class DeploymentPool:
    """Health-aware serving over a pool of (guarded) deployments.

    The fleet-scale pattern on top of the uniform Deployment contract: each
    member is typically a guarded deployment
    (breaker + canary + fallback), and the pool's job is *admission* and
    *backpressure*:

    * requests land in a bounded queue — a full queue **sheds at submit**
      (bounded backpressure, not an unbounded pile-up or a hard raise);
    * each :meth:`tick` dispatches queued requests round-robin across the
      members whose ``can_serve()`` says they can answer (a quarantined,
      fallback-less member takes no traffic — health-aware admission);
    * with *no* serveable member, the queue ages; requests older than
      ``max_wait_ticks`` are shed — sustained breaker-open turns into
      load-shedding instead of latency creep.

    Members are duck-typed: ``can_serve()``/``call()`` are used when
    present (a guarded deployment), plain callables serve unconditionally —
    so an unguarded Deployment can stand in a pool too.
    """

    def __init__(self, members, *, max_queue: int = 64,
                 max_wait_ticks: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if not members:
            raise ValueError("DeploymentPool needs at least one member")
        self.max_queue = max_queue
        self.max_wait_ticks = max_wait_ticks
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.ticks = 0
        # the queue ages on the pool's tick counter, not wall time: a
        # request submitted at tick T with max_wait_ticks W carries the
        # absolute deadline T + W on that clock.
        self._queue = AdmissionQueue(max_queue, clock=self._now,
                                     metrics=self.metrics,
                                     name="server.pool.queue")
        self._router = AffinityRouter(members, name="server.pool.router",
                                      metrics=self.metrics)
        self._next_rid = 0
        self.results: Dict[int, dict] = {}

    @property
    def members(self) -> List:
        return self._router.members

    def _now(self) -> float:
        return float(self.ticks)

    def _gauge_depth(self) -> None:
        self.metrics.gauge("server.pool.queue_depth").set(len(self._queue))

    # -- admission ------------------------------------------------------ #
    def submit(self, *args) -> int:
        """Enqueue one request; a full queue sheds it immediately (the
        result records ``status="shed"``). Returns the request id either
        way — the caller learns the outcome from :meth:`result`."""
        rid = self._next_rid
        self._next_rid += 1
        self.metrics.counter("server.pool.submitted").inc()
        deadline = (self.ticks + self.max_wait_ticks
                    if self.max_wait_ticks is not None else None)
        req = ServeRequest(rid=rid, design="pool", window=args,
                           t_submit=float(self.ticks), deadline_s=deadline)
        if not self._queue.offer(req):
            self.metrics.counter("server.pool.shed").inc()
            self.results[rid] = {"rid": rid, "status": "shed",
                                 "reason": "queue_full"}
            return rid
        self._gauge_depth()
        return rid

    def result(self, rid: int) -> Optional[dict]:
        return self.results.get(rid)

    def _serveable(self) -> List[int]:
        return self._router.serveable()

    # -- dispatch ------------------------------------------------------- #
    def tick(self) -> int:
        """One scheduling round: age-shed, then dispatch up to one request
        per serveable member (round-robin). Returns requests served."""
        self.ticks += 1
        self.metrics.counter("server.pool.ticks").inc()
        for req in self._queue.expire():     # deadline == max_wait_ticks
            self.metrics.counter("server.pool.shed").inc()
            self.results[req.rid] = {"rid": req.rid, "status": "shed",
                                     "reason": "max_wait_ticks"}
        healthy = self._serveable()
        self.metrics.gauge("server.pool.healthy_members").set(len(healthy))
        served = 0
        for req in self._queue.take(len(healthy)):
            try:
                member_i, m, _ = self._router.route()
            except NoServeableMember:        # raced to zero members
                self._queue.requeue([req])
                break
            entry = {"rid": req.rid, "member": member_i,
                     "waited_ticks": self.ticks - int(req.t_submit)}
            try:
                if hasattr(m, "call"):
                    res = m.call(*req.window)
                    entry.update(value=res.value, source=res.source,
                                 status=("degraded" if res.degraded
                                         else "ok"))
                else:
                    entry.update(value=m(*req.window), status="ok")
            except Exception as e:           # noqa: BLE001 - request lost
                entry.update(status="lost", error=type(e).__name__)
            self.metrics.counter(f"server.pool.{entry['status']}").inc()
            self.results[req.rid] = entry
            req.status = DONE
            served += 1
        self._gauge_depth()
        return served

    def drain(self, max_ticks: int = 10_000) -> PoolStats:
        """Tick until the queue empties (or nothing can serve and aging
        sheds the rest). Never raises: at ``max_ticks`` the remaining queue
        is shed and the partial stats returned."""
        while len(self._queue) and self.ticks < max_ticks:
            before = len(self._queue)
            self.tick()
            if (len(self._queue) == before and not self._serveable()
                    and self.max_wait_ticks is None):
                break                        # wedged: no member, no age-out
        for req in self._queue.take():
            req.status = SHED
            self.metrics.counter("server.pool.shed").inc()
            self.results[req.rid] = {"rid": req.rid, "status": "shed",
                                     "reason": "drain_truncated"}
        return self.stats()

    # kept as the canonical spelling's alias inside repro_torch.serving; the
    # *deprecated* shim (old import site, warns) lives in runtime.server.
    run_until_drained = drain

    def stats(self) -> PoolStats:
        mx = self.metrics
        g = mx.gauge("server.pool.queue_depth")
        return PoolStats(
            ticks=self.ticks,
            submitted=mx.counter("server.pool.submitted").value,
            served_ok=mx.counter("server.pool.ok").value,
            served_degraded=mx.counter("server.pool.degraded").value,
            shed=mx.counter("server.pool.shed").value,
            lost=mx.counter("server.pool.lost").value,
            max_queue_depth=int(g.max) if g.max is not None else 0)
