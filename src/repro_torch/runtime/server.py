"""Batched serving runtime: continuous-batching-lite with a fixed slot pool
(port of ``repro/runtime/server.py``).

  * a fixed pool of ``batch_slots`` sequences decodes in lock-step (one
    ``decode_step`` per tick over the whole pool);
  * new requests are prefilled and inserted into free slots with their KV
    caches padded to ``max_len``;
  * finished sequences (EOS or length) free their slot immediately;
  * the pool cache is updated in place: decode writes each tick's K/V into
    it and an admitted request's cache is copied into its slot, where the
    reference donates buffers;
  * on a mesh whose data axes divide the pool, each data rank holds,
    prefills and decodes only its own slots (:class:`Server`).

With the process tracer on, ``server.tick`` holds each admission's
``server.prefill`` and the pool's ``server.decode``, and each of those a
``model.forward`` around the model step alone (``mode``, ``rows``,
``tokens``); ``server.prefill`` and ``model.forward`` are timed on the
device too (``obs/trace.py``).

Sampling stays on the host with numpy (greedy or temperature), so greedy
tokens compare one for one with the reference's. ``DeploymentPool`` here
is the reference's deprecated import site of
:class:`repro_torch.serving.DeploymentPool`, kept as a warning shim.
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import shardmap as sm
from repro_torch.core.types import MeshConfig, ModelConfig, ParallelismConfig
from repro_torch.device import resolve_device
from repro_torch.model.layers import tree_map
from repro_torch.model.lm import (make_decode_step, make_prefill_step,
                                  model_blocks, pool_rows, pool_zeros,
                                  rows_region)
from repro_torch.model.moe import cuts_batch
from repro_torch.model.transformer import pad_cache
from repro_torch.obs import MetricsRegistry, get_tracer
# PoolStats is re-exported from its new home so old imports keep working
from repro_torch.serving.pool import DeploymentPool as _ServingPool
from repro_torch.serving.pool import PoolStats  # noqa: F401  (compat re-export)


@dataclass
class ServerConfig:
    batch_slots: int = 4
    max_len: int = 128
    eos_token: int = 1
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # per-request latency instrumentation (server clock; None until set)
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None


@dataclass
class ServerStats:
    """What one drain actually did, built from the server's metrics.

    ``ttft_s`` / ``latency_s`` are histogram summaries
    (count/mean/p50/p95/p99...): time-to-first-token is submit -> first
    token out of prefill; total latency is submit -> retire.
    """

    ticks: int = 0
    submitted: int = 0
    admitted: int = 0
    retired: int = 0
    max_queue_depth: int = 0
    max_slots_busy: int = 0
    ttft_s: Dict[str, float] = field(default_factory=dict)
    latency_s: Dict[str, float] = field(default_factory=dict)


class DrainResult(list):
    """The retired requests (a plain list) with the drain's
    :class:`ServerStats` riding along as ``.stats``.

    ``drained`` says whether the server actually emptied; a drain that
    tripped ``max_ticks`` comes back with ``drained=False`` and the
    still-in-flight requests in ``pending``.
    """

    def __init__(self, requests, stats: ServerStats, *,
                 drained: bool = True, pending=()):
        super().__init__(requests)
        self.stats = stats
        self.drained = drained
        self.pending = list(pending)


class Server:
    """``params`` (whole) must live on ``device`` (None means CUDA, or
    raise). ``mesh``: the device mesh of ``mesh_cfg`` the steps run on, or
    None. On a mesh the server keeps only the rank's blocks of ``params``
    (``lm.model_blocks``, cut once here), each step computes its share of
    the heads, hidden widths, vocabulary and experts over ``"model"``, and
    the caches hold its kv heads. Where the data axes divide
    ``batch_slots`` (``lm.pool_rows``, the reference's batch layout) the
    pool is cut over them: data rank ``d`` holds the cache rows of slots
    ``[d·k, (d+1)·k)``, prefills only the requests admitted into them and
    decodes only those rows, and the last-position logits of every row
    are gathered over the data axes, so that every rank samples the same
    tokens. Otherwise every data rank holds, prefills and decodes the
    whole pool. The host state (queue, slots, last tokens, sampler) is
    the same on every rank, so every rank takes the same branches and
    joins the same collectives."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig,
                 mesh_cfg: MeshConfig, par: Optional[ParallelismConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter, mesh=None):
        self.cfg = cfg
        self.scfg = scfg
        self.params = (params if mesh is None
                       else model_blocks(params, cfg, mesh_cfg, mesh))
        self.device = resolve_device(device)
        par = par or ParallelismConfig(compute_dtype="float32")
        self._prefill = make_prefill_step(cfg, mesh_cfg, par, mesh)
        self._decode = make_decode_step(cfg, mesh_cfg, par, mesh)
        self._rng = np.random.default_rng(scfg.seed)
        self._slots: List[Optional[Request]] = [None] * scfg.batch_slots
        self._cache = None            # this rank's rows of the pool cache
        self._last_tok = np.zeros((scfg.batch_slots, 1), np.int64)
        self._queue: List[Request] = []
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        # the pool's layout over the data axes: this rank's slots
        # [lo, lo + k), all of them where the pool is whole
        self._mesh, self._mesh_cfg, self._par = mesh, mesh_cfg, par
        self._rows = None if mesh is None else pool_rows(mesh_cfg,
                                                         scfg.batch_slots)
        self._lo, self._k = 0, scfg.batch_slots
        if self._rows is not None:
            axes, self._k = self._rows
            with sm.region(mesh, axes):
                self._lo = sm.axis_index(axes) * self._k
        # a prefill holds one request: an MoE whose dispatch cuts its
        # batch over more than one data rank refuses it, as the
        # reference's shard_map does; every rank raises before any
        # collective
        dp = math.prod(mesh_cfg.axis_size(a) for a in mesh_cfg.dp_axes)
        self._refusal = None
        if (mesh is not None and dp > 1
                and cuts_batch(cfg, mesh_cfg.axis_size("model"))):
            self._refusal = (
                f"the {cfg.moe.impl!r} MoE cuts a prefill's batch of 1 over "
                f"the data axes {mesh_cfg.dp_axes} ({dp} ranks), which do "
                "not divide it (the reference's shard_map refuses it too); "
                "serve with moe.impl='dense' or on one data rank")
        # observability: the server owns its registry (injectable for
        # tests); the clock is injectable too so latency histograms are
        # deterministic under test.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.clock = clock

    # ------------------------------------------------------------------ #
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, list(prompt), max_new_tokens,
                      t_submit=self.clock())
        self._queue.append(req)
        self.requests[rid] = req
        self.metrics.counter("server.submitted").inc()
        return rid

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admit(self) -> None:
        """One admission round: the queue's head into the free slots in
        index order. With the pool whole each request is prefilled and
        sampled in turn; cut over the data axes each rank prefills the
        requests of its own slots, the round's last-position logits are
        gathered over the data axes (``server.exchange``), and every rank
        samples them in admission order (``t_first_token`` is stamped
        then)."""
        admitted = []
        for slot in self._free_slots():
            if not self._queue:
                break
            admitted.append((slot, self._queue.pop(0)))
        if not admitted:
            return
        if self._refusal is not None:
            raise ValueError(self._refusal)
        if self._rows is None:
            for slot, req in admitted:
                self._first_token(slot, req, self._prefill_into(slot, req))
            return
        lo, k = self._lo, self._k
        last = torch.zeros((k, self.cfg.padded_vocab), dtype=torch.float32,
                           device=self.device)
        for slot, req in admitted:
            if lo <= slot < lo + k:
                last[slot - lo] = self._prefill_into(slot, req)[0]
        if self._cache is None:       # no request of this rank's yet
            self._cache = pool_zeros(self.cfg, self._mesh_cfg, self._par,
                                     self.scfg.batch_slots,
                                     self.scfg.max_len, self._mesh,
                                     self.device)
        logits = self._gather_rows(last)
        for slot, req in admitted:
            self._first_token(slot, req, logits[slot:slot + 1])

    def _prefill_into(self, slot: int, req: Request) -> torch.Tensor:
        """Prefill ``req``, one of this rank's slots, and install its cache
        padded to ``max_len`` in its row; its last-position logits
        ``(1, V)``."""
        tokens = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)
        trc = get_tracer()
        with trc.span("server.prefill", device=self.device, rid=req.rid,
                      prompt_len=len(req.prompt)):
            with torch.no_grad(), trc.span(
                    "model.forward", device=self.device, mode="prefill",
                    rows=1, tokens=len(req.prompt)):
                logits, cache = self._prefill(self.params, {"tokens": tokens})
            self._install(slot - self._lo, pad_cache(cache,
                                                     self.scfg.max_len))
        return logits

    def _first_token(self, slot: int, req: Request,
                     logits: torch.Tensor) -> None:
        tok = self._sample(logits.cpu().numpy())
        req.out_tokens.append(int(tok[0]))
        req.t_first_token = self.clock()
        self.metrics.counter("server.admitted").inc()
        self.metrics.histogram("server.ttft_s").observe(
            req.t_first_token - req.t_submit)
        self._slots[slot] = req
        self._last_tok[slot, 0] = tok[0]

    def _install(self, row: int, cache) -> None:
        """``cache`` (one request's) into ``row`` of this rank's rows."""
        if self._cache is None:
            # materialize the pool cache by tiling the first request's cache
            self._cache = tree_map(
                lambda a: torch.cat([a] * self._k, dim=0), cache)
        else:
            tree_map(lambda pool, one: pool[row:row + 1].copy_(one),
                     self._cache, cache)

    def _over_rows(self):
        """The region of this rank's rows of the pool (none where the pool
        is whole)."""
        if self._rows is None:
            return contextlib.nullcontext()
        return rows_region(self._mesh, self._rows[0], self._k)

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``k`` rows of ``x``, in slot order."""
        if self._rows is None:
            return x
        with get_tracer().span("server.exchange", rows=self._k), \
                self._over_rows():
            return sm.all_gather(x, self._rows[0], axis=0, tiled=True)

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.scfg.temperature <= 0.0:
            return logits.argmax(-1).astype(np.int32)
        z = logits / self.scfg.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([self._rng.choice(len(row), p=row) for row in p],
                        np.int32)

    # ------------------------------------------------------------------ #
    def step(self) -> None:
        """One server tick: admit new work, decode the pool, retire done.

        Each tick records queue depth and slot occupancy (gauges track the
        max) plus admit/retire counters; every retiring request observes
        its total submit->retire latency.
        """
        mx = self.metrics
        mx.counter("server.ticks").inc()
        mx.gauge("server.queue_depth").set(len(self._queue))
        trc = get_tracer()
        with trc.span("server.tick", queue_depth=len(self._queue),
                      slots_busy=self._busy_slots()):
            self._admit()
            mx.gauge("server.slots_busy").set(self._busy_slots())
            if all(s is None for s in self._slots):
                return
            with trc.span("server.decode", slots_busy=self._busy_slots()):
                tokens = torch.from_numpy(
                    self._last_tok[self._lo:self._lo + self._k])
                with torch.no_grad(), self._over_rows(), trc.span(
                        "model.forward", device=self.device, mode="decode",
                        rows=self._k, tokens=self._k):
                    logits, self._cache = self._decode(
                        self.params, tokens.to(self.device), self._cache)
                toks = self._sample(self._gather_rows(logits).cpu().numpy())
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                t = int(toks[i])
                req.out_tokens.append(t)
                self._last_tok[i, 0] = t
                if (t == self.scfg.eos_token
                        or len(req.out_tokens) >= req.max_new_tokens):
                    req.done = True
                    req.t_done = self.clock()
                    self._slots[i] = None
                    mx.counter("server.retired").inc()
                    mx.histogram("server.latency_s").observe(
                        req.t_done - req.t_submit)

    def _busy_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def stats(self) -> ServerStats:
        """The drain summary, straight from the metrics registry."""
        mx = self.metrics

        def _count(name):
            return mx.counter(name).value

        def _gmax(name):
            g = mx.gauge(name)
            return int(g.max) if g.max is not None else 0

        return ServerStats(
            ticks=_count("server.ticks"),
            submitted=_count("server.submitted"),
            admitted=_count("server.admitted"),
            retired=_count("server.retired"),
            max_queue_depth=_gmax("server.queue_depth"),
            max_slots_busy=_gmax("server.slots_busy"),
            ttft_s=mx.histogram("server.ttft_s").summary(),
            latency_s=mx.histogram("server.latency_s").summary())

    def run_until_drained(self, max_ticks: int = 10_000, *,
                          strict: bool = False) -> DrainResult:
        """Tick until queue and slots are empty. Returns the retired
        requests with ``.stats`` attached.

        Tripping ``max_ticks`` returns a *partial* :class:`DrainResult`
        with ``drained=False`` and the in-flight requests in ``pending``;
        ``strict=True`` raises with the live queue/slot state instead."""
        ticks = 0
        while self._queue or any(s is not None for s in self._slots):
            self.step()
            ticks += 1
            if ticks > max_ticks:
                busy = [(i, s.rid, len(s.out_tokens), s.max_new_tokens)
                        for i, s in enumerate(self._slots) if s is not None]
                if strict:
                    raise RuntimeError(
                        "server did not drain within max_ticks="
                        f"{max_ticks}: {len(self._queue)} queued "
                        f"(rids {[r.rid for r in self._queue[:8]]}), "
                        f"{len(busy)} slots busy "
                        f"(slot, rid, out/max: {busy}); "
                        f"stats={self.stats()}")
                self.metrics.counter("server.drain_truncated").inc()
                pending = ([s for s in self._slots if s is not None]
                           + list(self._queue))
                done = [r for r in self.requests.values() if r.done]
                return DrainResult(sorted(done, key=lambda r: r.rid),
                                   self.stats(), drained=False,
                                   pending=sorted(pending,
                                                  key=lambda r: r.rid))
        return DrainResult(sorted(self.requests.values(),
                                  key=lambda r: r.rid), self.stats())


class DeploymentPool(_ServingPool):
    """Deprecated import site for the health-aware pool.

    The pool lives in :mod:`repro_torch.serving.pool`, rebuilt on the
    shared serving primitives (admission queue + router); this subclass
    keeps the old constructor and ``run_until_drained`` spellings alive as
    thin forwarding shims. Import :class:`repro_torch.serving.DeploymentPool`
    and call :meth:`~repro_torch.serving.pool.DeploymentPool.drain`
    instead.
    """

    def __init__(self, members, *, max_queue: int = 64,
                 max_wait_ticks: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        warnings.warn(
            "repro_torch.runtime.server.DeploymentPool moved to "
            "repro_torch.serving.DeploymentPool (and run_until_drained() "
            "to drain()); this forwarding shim will be removed",
            DeprecationWarning, stacklevel=2)
        super().__init__(members, max_queue=max_queue,
                         max_wait_ticks=max_wait_ticks, metrics=metrics)

    def run_until_drained(self, max_ticks: int = 10_000) -> PoolStats:
        warnings.warn(
            "DeploymentPool.run_until_drained() is deprecated; use "
            "repro_torch.serving.DeploymentPool.drain()",
            DeprecationWarning, stacklevel=2)
        return self.drain(max_ticks)
