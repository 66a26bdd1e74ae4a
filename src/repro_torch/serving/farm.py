"""The accelerator-farm runtime: queue → micro-batcher → router → pools
(port of ``repro/serving/farm.py``).

This is the fleet-scale serving layer over the uniform Deployment API
(DESIGN.md §14): many concurrent request streams multiplex onto pools of
deployed accelerators. One :class:`AcceleratorFarm` owns

* a bounded :class:`~repro_torch.serving.queue.AdmissionQueue` with deadlines
  (backpressure at the door, aging into load-shedding);
* a :class:`~repro_torch.serving.batcher.MicroBatcher` that coalesces admitted
  requests per ``(design, window-length bucket)`` and packs each group
  into one padded batch dispatch (pad-ragged-then-dechunk, bit-exact);
* per-design :class:`~repro_torch.serving.router.AffinityRouter`s over
  pools of members (typically :class:`~repro_torch.rtl.backend.
  RTLExecutable` replicas, each with its own program cache) with
  compiled-program affinity;
* ``serving.*`` spans, counters and latency histograms
  (:mod:`repro_torch.obs`) — p50/p99 request latency, batch fill, queue wait.

Requests admitted to the queue are never silently dropped: every request
reaches exactly one terminal state (``done`` / ``shed`` / ``expired`` /
``failed``), and :meth:`AcceleratorFarm.stats` reconciles the counts — the
serving gate asserts ``failed == 0`` and ``admitted == done + expired``.

A failed dispatch (member raised through its guard) is redispatched once
across the remaining healthy members before its requests are marked
``failed`` — farm-level routing around a sick member composes with any
member-level retry/breaker/fallback guard.

A member's answer may be a tensor on the card; it comes back to the host
(numpy) before the de-chunk, so requests hold host arrays, as in the
reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry, get_tracer
from repro_torch.serving.batcher import MicroBatch, MicroBatcher, unpack
from repro_torch.serving.queue import (DONE, EXPIRED, FAILED, AdmissionQueue,
                                 ServeRequest, SHED)
from repro_torch.serving.router import AffinityRouter, NoServeableMember


def _host(out) -> np.ndarray:
    """A member's answer as a host array (a tensor may be on the card)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


@dataclass(frozen=True)
class FarmConfig:
    """The farm's knobs, one validated frozen dataclass."""

    max_queue: int = 4096            # admission bound (backpressure)
    max_batch: int = 64              # rows per dispatch
    max_wait_s: float = 0.002        # partial-batch linger before flushing
    pad_batch: bool = True           # quantize B to powers of two (no
    #                                  retrace under mixed batch sizes)

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, "
                             f"got {self.max_wait_s}")


@dataclass
class DesignPool:
    """One served design family: the deployments (replicas) behind it and
    the window lengths its lowered variants accept.

    ``members`` maps each registered window length to the replica list
    lowered *at* that length (a fixed-window accelerator only accepts its
    own ``(B, L, F)``). ``flops_per_window`` / ``energy_per_window_j`` per
    length feed the loadgen's GOP/J accounting (both deterministic: the op
    count and the cycle model, not wall clock).
    """

    family: str
    members: Dict[int, List]                      # bucket length -> replicas
    flops_per_window: Dict[int, float] = field(default_factory=dict)
    energy_per_window_j: Dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        if not self.members:
            raise ValueError(f"design {self.family!r} has no members")
        for ln, reps in self.members.items():
            if not reps:
                raise ValueError(
                    f"design {self.family!r} bucket {ln} has no replicas")

    @property
    def window_lengths(self) -> Tuple[int, ...]:
        return tuple(sorted(self.members))


@dataclass
class FarmStats:
    """What the farm actually did, reconciled from its metrics."""

    submitted: int = 0
    admitted: int = 0
    shed: int = 0                    # at the door (queue full / no bucket)
    expired: int = 0                 # deadline passed while queued
    done: int = 0
    failed: int = 0                  # every redispatch exhausted
    dispatches: int = 0
    redispatches: int = 0
    windows_dispatched: int = 0      # padded rows included
    affinity_hits: int = 0
    affinity_misses: int = 0
    max_queue_depth: int = 0
    latency_s: Dict[str, float] = field(default_factory=dict)
    queue_wait_s: Dict[str, float] = field(default_factory=dict)
    batch_fill: Dict[str, float] = field(default_factory=dict)
    batch_size: Dict[str, float] = field(default_factory=dict)
    per_design: Dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)


class AcceleratorFarm:
    """Queue + batcher + affinity-routed pools, one tick loop.

    ``submit`` is the only producer API; :meth:`tick` is one scheduling
    round (expire → drain → batch → dispatch → de-chunk);
    :meth:`run_until_drained` ticks with ``flush=True`` until the queue
    empties. The clock and metrics registry are injectable so latency
    histograms replay exactly under test.
    """

    def __init__(self, pools: Sequence[DesignPool],
                 cfg: FarmConfig = FarmConfig(), *,
                 clock=time.perf_counter,
                 metrics: Optional[MetricsRegistry] = None):
        if not pools:
            raise ValueError("AcceleratorFarm needs at least one DesignPool")
        self.cfg = cfg
        self.clock = clock
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.pools: Dict[str, DesignPool] = {}
        self.routers: Dict[Tuple[str, int], AffinityRouter] = {}
        for pool in pools:
            if pool.family in self.pools:
                raise ValueError(f"duplicate design {pool.family!r}")
            self.pools[pool.family] = pool
            for ln, reps in pool.members.items():
                self.routers[(pool.family, ln)] = AffinityRouter(
                    reps, name=f"serving.router.{pool.family}.{ln}",
                    metrics=self.metrics)
        self.queue = AdmissionQueue(cfg.max_queue, clock=clock,
                                    metrics=self.metrics)
        self.batcher = MicroBatcher(
            buckets={f: p.window_lengths for f, p in self.pools.items()},
            max_batch=cfg.max_batch, max_wait_s=cfg.max_wait_s,
            pad_batch=cfg.pad_batch)
        self._next_rid = 0
        self.requests: Dict[int, ServeRequest] = {}
        self.ticks = 0

    # -- producer API --------------------------------------------------- #
    def submit(self, design: str, window, *,
               deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue one window for ``design``. Returns the request id; the
        outcome (including an immediate shed) is read via :meth:`result`.

        ``deadline_s`` is absolute on the farm clock; ``timeout_s`` is the
        relative convenience spelling (now + timeout).
        """
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        if timeout_s is not None:
            deadline_s = now + timeout_s if deadline_s is None \
                else min(deadline_s, now + timeout_s)
        req = ServeRequest(rid=rid, design=design, window=window,
                           t_submit=now, deadline_s=deadline_s)
        self.requests[rid] = req
        self.metrics.counter("serving.submitted").inc()
        if design not in self.pools:
            req.status = SHED
            req.error = (f"unknown design {design!r}; registered: "
                         f"{sorted(self.pools)}")
            self.metrics.counter("serving.queue.shed_full").inc()
            return rid
        try:
            self.batcher.bucket(design, int(np.asarray(window).shape[0]))
        except ValueError as e:          # no lowered variant fits: shed now
            req.status = SHED
            req.error = str(e)
            self.metrics.counter("serving.queue.shed_full").inc()
            return rid
        self.queue.offer(req)
        return rid

    def result(self, rid: int) -> Optional[ServeRequest]:
        return self.requests.get(rid)

    # -- scheduling ----------------------------------------------------- #
    def tick(self, *, flush: bool = False) -> int:
        """One scheduling round; returns requests completed this round."""
        self.ticks += 1
        self.metrics.counter("serving.ticks").inc()
        trc = get_tracer()
        with trc.span("serving.tick", tick=self.ticks,
                      queue_depth=len(self.queue)):
            self.queue.expire()
            taken = self.queue.take()
            if not taken:
                return 0
            batches, lingering = self.batcher.form(
                taken, now=self.clock(), flush=flush)
            self.queue.requeue(lingering)
            completed = 0
            for batch in batches:
                completed += self._dispatch(batch)
            return completed

    def _dispatch(self, batch: MicroBatch) -> int:
        """Route one packed batch, execute, de-chunk; redispatch once on
        member failure before marking the batch's requests failed.

        Deadlines are re-checked here: a request can expire *between*
        ``queue.take()`` and dispatch (batch forming takes wall time, and
        a lingering partial batch may carry old requests), which
        ``queue.expire`` can no longer catch. Expired rows stay in the
        packed array (row i ↔ request i alignment is the de-chunk
        contract) but are marked terminal before the dispatch and never
        receive a result; they count under the same
        ``serving.queue.expired`` counter as queue-side expiry, keeping
        the ``admitted == done + expired`` reconciliation exact.
        """
        mx = self.metrics
        trc = get_tracer()
        arr = batch.array
        t_dispatch = self.clock()
        live: List[ServeRequest] = []
        for req in batch.requests:
            if req.deadline_s is not None and t_dispatch >= req.deadline_s:
                req.status = EXPIRED     # missed between take() and here
                req.error = "deadline"
                req.t_done = t_dispatch
                mx.counter("serving.queue.expired").inc()
            else:
                live.append(req)
        if not live:
            return 0
        for req in live:                 # queued -> on the wire
            mx.histogram("serving.queue_wait_s").observe(
                t_dispatch - req.t_submit)
        tried: Tuple[int, ...] = ()
        router = self.routers[(batch.design, batch.bucket_len)]
        for attempt in range(2):
            try:
                idx, member, hit = router.route(arr.shape, arr.dtype,
                                                exclude=tried)
            except NoServeableMember as e:
                return self._fail(batch, type(e).__name__)
            try:
                with trc.span("serving.dispatch", design=batch.design,
                              bucket=batch.bucket_len,
                              batch=int(arr.shape[0]),
                              fill=round(batch.fill, 3), member=idx,
                              affinity_hit=hit, attempt=attempt):
                    res = member.call(arr) if hasattr(member, "call") \
                        else member(arr)
                out = res.value if hasattr(res, "value") else res
                out = _host(out)
            except Exception as e:       # noqa: BLE001 - route around it
                tried = tried + (idx,)
                mx.counter("serving.redispatches").inc()
                if attempt == 1:
                    return self._fail(batch, type(e).__name__)
                continue
            now = self.clock()
            mx.counter("serving.dispatches").inc()
            mx.counter("serving.windows_dispatched").inc(int(arr.shape[0]))
            mx.histogram("serving.batch_fill").observe(batch.fill)
            mx.histogram("serving.batch_size").observe(len(live))
            unpack(batch, out)           # skips terminal (expired) rows
            for req in live:
                req.status = DONE
                req.t_done = now
                req.member = idx
                req.batch_size = int(arr.shape[0])
                mx.counter("serving.done").inc()
                mx.counter(f"serving.done.{batch.design}").inc()
                mx.histogram("serving.latency_s").observe(
                    now - req.t_submit)
                mx.histogram(
                    f"serving.latency_s.{batch.design}").observe(
                    now - req.t_submit)
            return len(live)
        return 0                         # unreachable; keeps mypy honest

    def _fail(self, batch: MicroBatch, error: str) -> int:
        now = self.clock()
        for req in batch.requests:
            if req.terminal:             # e.g. expired at dispatch time
                continue
            req.status = FAILED
            req.error = error
            req.t_done = now
            self.metrics.counter("serving.failed").inc()
        return 0

    def run_until_drained(self, max_ticks: int = 100_000) -> "FarmStats":
        """Tick (flushing partial batches) until the queue empties."""
        ticks = 0
        while len(self.queue):
            self.tick(flush=True)
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"farm did not drain within max_ticks={max_ticks}: "
                    f"{len(self.queue)} queued; stats={self.stats()}")
        return self.stats()

    # -- accounting ----------------------------------------------------- #
    def stats(self) -> FarmStats:
        mx = self.metrics

        def c(name):
            return mx.counter(name).value

        g = mx.gauge("serving.queue.depth")
        per_design = {}
        for family, pool in self.pools.items():
            h = mx.histogram(f"serving.latency_s.{family}")
            per_design[family] = {
                "done": c(f"serving.done.{family}"),
                "window_lengths": list(pool.window_lengths),
                "latency_s": h.summary() if h.count else {},
            }
        return FarmStats(
            submitted=c("serving.submitted"),
            admitted=c("serving.queue.admitted"),
            shed=c("serving.queue.shed_full"),
            expired=c("serving.queue.expired"),
            done=c("serving.done"),
            failed=c("serving.failed"),
            dispatches=c("serving.dispatches"),
            redispatches=c("serving.redispatches"),
            windows_dispatched=c("serving.windows_dispatched"),
            affinity_hits=sum(
                v.value for k, v in mx.counters.items()
                if k.endswith(".affinity_hit")),
            affinity_misses=sum(
                v.value for k, v in mx.counters.items()
                if k.endswith(".affinity_miss")),
            max_queue_depth=int(g.max) if g.max is not None else 0,
            latency_s=mx.histogram("serving.latency_s").summary(),
            queue_wait_s=mx.histogram("serving.queue_wait_s").summary(),
            batch_fill=mx.histogram("serving.batch_fill").summary(),
            batch_size=mx.histogram("serving.batch_size").summary(),
            per_design=per_design)
