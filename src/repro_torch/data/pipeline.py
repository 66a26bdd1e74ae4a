"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``; numpy, so every batch is the reference's bit for
bit for every ``(seed, step)``).

Two corpora:

* **LM corpus** — a seeded Markov-ish token stream with learnable structure
  (bigram transitions over a banded matrix + topic drift), so a ~100M model
  visibly learns (loss drops well below ln(V)) without any external data.
  Batches are a pure function of ``(seed, step)`` — after a crash+restore the
  iterator resumes exactly, which is what makes checkpoint/restart exact.

* **Traffic-flow series** — the paper's LSTM workload: a daily-period signal
  with noise, windowed into (lag=6 → next) samples, matching ref [11].

Host-side prefetch is a small thread that stays ``n`` batches ahead.
Batches are numpy arrays; a caller puts them on its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


# ---------------------------------------------------------------------------
# LM corpus
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    band: int = 64              # bigram band width (structure to learn)
    n_topics: int = 16


def _bigram_next(tok: np.ndarray, rng: np.random.Generator, v: int,
                 band: int, topic: np.ndarray) -> np.ndarray:
    """Next token: banded bigram + topic bias — cheap but learnable."""
    base = (tok * 31 + 7) % v
    off = rng.integers(0, band, size=tok.shape)
    drift = (topic * 101) % v
    return (base + off + drift) % v


def lm_batch_for_step(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg.seed, step) — restart-exact."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    topic = rng.integers(0, cfg.n_topics, size=(B, 1))
    toks = np.empty((B, S + 1), np.int32)
    toks[:, 0] = rng.integers(0, V, size=B)
    for t in range(S):
        toks[:, t + 1] = _bigram_next(toks[:, t], rng, V, cfg.band,
                                      topic[:, 0])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def make_lm_iterator(cfg: LMDataConfig, start_step: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield lm_batch_for_step(cfg, step)
        step += 1


# ---------------------------------------------------------------------------
# Traffic-flow series (the paper's workload)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficConfig:
    seq_len: int = 6
    batch: int = 64
    seed: int = 0
    period: int = 288           # 5-min samples per day
    noise: float = 0.05


def traffic_flow_batch(cfg: TrafficConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    starts = rng.integers(0, 10_000, size=cfg.batch)
    t = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
    # two harmonics of the daily cycle + slow weekly trend + noise
    flow = (0.6 * np.sin(2 * np.pi * t / cfg.period)
            + 0.3 * np.sin(4 * np.pi * t / cfg.period + 1.0)
            + 0.1 * np.sin(2 * np.pi * t / (7 * cfg.period))
            + cfg.noise * rng.standard_normal(t.shape))
    x = flow[:, :-1, None].astype(np.float32)
    y = flow[:, -1:, ].astype(np.float32)
    return {"x": x, "y": y}


# ---------------------------------------------------------------------------
# Multichannel sensor windows (the conv1d workload)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SensorConfig:
    """IMU-style synthetic stream: per-channel harmonics + bursts + noise."""

    seq_len: int = 16
    channels: int = 3
    batch: int = 64
    seed: int = 0
    noise: float = 0.05


def sensor_window_batch(cfg: SensorConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg.seed, step) — restart-exact, like the others.

    The target is the window's mean motion intensity (channel-weighted mean
    of |x| over the last half of the window) — a burst-detection style
    regression a depthwise TCN can learn from local tap patterns.
    """
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 7]))
    B, S, C = cfg.batch, cfg.seq_len, cfg.channels
    starts = rng.integers(0, 10_000, size=(B, 1, 1))
    t = starts + np.arange(S)[None, :, None]
    ch = np.arange(C)[None, None, :]
    phase = 2 * np.pi * t / (12.0 + 3.0 * ch)
    burst = (rng.random((B, 1, C)) < 0.3).astype(np.float32)
    x = (0.5 * np.sin(phase)
         + 0.25 * np.sin(2.1 * phase + ch)
         + 0.4 * burst * np.sin(5.0 * phase)
         + cfg.noise * rng.standard_normal((B, S, C)))
    w_ch = np.linspace(1.0, 0.5, C)[None, None, :]
    y = (np.abs(x[:, S // 2:, :]) * w_ch).mean(axis=(1, 2), keepdims=False)
    return {"x": x.astype(np.float32), "y": y[:, None].astype(np.float32)}


# ---------------------------------------------------------------------------
# Prefetch
# ---------------------------------------------------------------------------


class Prefetcher:
    """Thread that keeps ``depth`` host batches ready; ``.close()`` to stop."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
