"""Batched serving runtime: continuous-batching-lite with a fixed slot pool
(port of ``repro/runtime/server.py``).

  * a fixed pool of ``batch_slots`` sequences decodes in lock-step (one
    ``decode_step`` per tick over the whole pool);
  * new requests are prefilled and inserted into free slots with their KV
    caches padded to ``max_len``;
  * finished sequences (EOS or length) free their slot immediately;
  * the pool cache is updated in place: decode writes each tick's K/V into
    it and an admitted request's cache is copied into its slot, where the
    reference donates buffers.

Sampling stays on the host with numpy (greedy or temperature), so greedy
tokens compare one for one with the reference's. ``DeploymentPool`` here
is the reference's deprecated import site of
:class:`repro_torch.serving.DeploymentPool`, kept as a warning shim.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.types import MeshConfig, ModelConfig, ParallelismConfig
from repro_torch.device import resolve_device
from repro_torch.model.layers import tree_map
from repro_torch.model.lm import (make_decode_step, make_prefill_step,
                                  model_blocks)
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
    None. On a mesh every rank serves the same requests, one prefill at a
    time: the server keeps only the rank's blocks of ``params``
    (``lm.model_blocks``, cut once here), each step computes its share of
    the heads, hidden widths, vocabulary and experts over ``"model"``, the
    caches hold its kv heads, and every rank samples from the whole
    last-position logits."""

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
        self._cache = None            # batched cache across slots
        self._last_tok = np.zeros((scfg.batch_slots, 1), np.int64)
        self._queue: List[Request] = []
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
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
        for slot in self._free_slots():
            if not self._queue:
                break
            req = self._queue.pop(0)
            tokens = torch.tensor([req.prompt], dtype=torch.int64,
                                  device=self.device)
            with get_tracer().span("server.prefill", rid=req.rid,
                                   prompt_len=len(req.prompt)):
                with torch.no_grad():
                    logits, cache = self._prefill(self.params,
                                                  {"tokens": tokens})
                cache = pad_cache(cache, self.scfg.max_len)
                tok = self._sample(logits.cpu().numpy())
            req.out_tokens.append(int(tok[0]))
            req.t_first_token = self.clock()
            self.metrics.counter("server.admitted").inc()
            self.metrics.histogram("server.ttft_s").observe(
                req.t_first_token - req.t_submit)
            self._install(slot, req, cache, tok)

    def _install(self, slot: int, req, cache, tok) -> None:
        self._slots[slot] = req
        self._last_tok[slot, 0] = tok[0]
        if self._cache is None:
            # materialize the pool cache by tiling the first request's cache
            self._cache = tree_map(
                lambda a: torch.cat([a] * self.scfg.batch_slots, dim=0),
                cache)
        else:
            tree_map(lambda pool, one: pool[slot:slot + 1].copy_(one),
                     self._cache, cache)

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
                with torch.no_grad():
                    logits, self._cache = self._decode(
                        self.params,
                        torch.from_numpy(self._last_tok).to(self.device),
                        self._cache)
                toks = self._sample(logits.cpu().numpy())
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
