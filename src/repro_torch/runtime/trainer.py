"""Fault-tolerant training loop: checkpoint/restart, deterministic replay,
straggler monitoring, elastic restart (port of
``repro/runtime/trainer.py``).

The recovery contract:
  * batches are a pure function of ``(seed, step)`` (see
    ``repro_torch.data``), so a restore at step k replays batch k exactly —
    no data loss or duplication;
  * checkpoints are atomic and async (``repro_torch.checkpoint``);
  * on :class:`PreemptionError` the loop restores the last checkpoint and
    continues — the path a cluster agent takes after rescheduling;
  * ``Trainer.resume_elastic`` restores the same checkpoint onto another
    stepper, device and mesh (a checkpoint written on the CPU onto the
    card, or by a (4, 2) mesh onto a (2, 4) one).

The step is the stepper's train step in its donating form
(``Stepper.train_fn(donate=True)``): the update writes into the parameter
and moment buffers, where the reference donates them to ``jax.jit``, so
the card holds one copy of the training state.

On a stepper with a mesh every rank of it runs this loop on its blocks of
the state (``Stepper.state_shardings``) with the same batches; a
checkpoint is gathered whole on rank 0's host, leaf by leaf
(``ckpt.gather_tree``), and written by rank 0, which alone keeps
``metrics_log``; a restore reads each rank's blocks. Building the first
state and ``resume_elastic``'s ``like`` still make the whole state on
every rank before it is cut, as the reference's do.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, gather_tree
from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
from repro_torch.device import resolve_device
from repro_torch.model.layers import local_blocks
from repro_torch.model.lm import Stepper
from repro_torch.optim.adamw import init_opt_state
from repro_torch.runtime.failures import FailureInjector, PreemptionError


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0      # step > factor×median -> straggler
    max_recoveries: int = 100


@dataclass
class Trainer:
    """Trains ``stepper`` on ``device`` (None means CUDA, or raise); each
    step's batch is made on the host and copied there."""

    stepper: Stepper
    data_cfg: LMDataConfig
    cfg: TrainerConfig = field(default_factory=TrainerConfig)
    injector: Optional[FailureInjector] = None
    batch_fn: Optional[Callable[[Any, int], Dict[str, np.ndarray]]] = None
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(self.cfg.ckpt_dir, keep=self.cfg.keep)
        self._step_fn = self.stepper.train_fn(donate=True)
        self._shardings = (self.stepper.state_shardings()
                           if self.stepper.mesh is not None else None)
        self._step_times: List[float] = []
        self.metrics_log: List[Dict[str, float]] = []
        self.recoveries = 0
        self.stragglers = 0

    # ------------------------------------------------------------------ #
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        host = (self.batch_fn(self.data_cfg, step) if self.batch_fn
                is not None else lm_batch_for_step(self.data_cfg, step))
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host.items()}

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs: rank 0 of a
        mesh, or the one process without one."""
        mesh = self.stepper.mesh
        return mesh is None or not any(mesh.get_coordinate() or [1])

    def _init_state(self):
        params = self.stepper.init(device=self.device)
        state = {"params": params, "opt": init_opt_state(params)}
        if self._shardings is not None:
            state = local_blocks(state, self._shardings)
        return state

    def _sync(self) -> None:
        """Every rank of the mesh waits here (rank 0's last write is on
        disk for the others to read)."""
        mesh = self.stepper.mesh
        if mesh is None or mesh.size() == 1:
            return
        from repro_torch import shardmap as sm

        with sm.region(mesh):
            sm.psum(torch.zeros(1, device=self.device),
                    tuple(mesh.mesh_dim_names))

    def _try_restore(self, state):
        self._sync()
        latest = self.ckpt.latest()
        if latest is None:
            return 0, state
        step, restored = self.ckpt.restore(state, self._shardings)
        return step + 1, restored

    def _save(self, step: int, state) -> None:
        if self._shardings is not None:
            state = gather_tree(state, self._shardings, self.stepper.mesh)
        if self.is_writer:
            self.ckpt.save_async(step, state)

    # ------------------------------------------------------------------ #
    def train(self) -> Dict[str, Any]:
        """Run to total_steps, surviving injected/real failures."""
        state = self._init_state()
        step, state = self._try_restore(state)
        while step < self.cfg.total_steps:
            try:
                step, state = self._run_span(step, state)
            except PreemptionError:
                self.recoveries += 1
                if self.recoveries > self.cfg.max_recoveries:
                    raise
                self.ckpt.wait()
                state = None                    # fresh process, fresh memory
                state = self._init_state()
                step, state = self._try_restore(state)
        self.ckpt.wait()
        return {"state": state, "steps": step, "recoveries": self.recoveries,
                "stragglers": self.stragglers, "metrics": self.metrics_log}

    def _run_span(self, step: int, state):
        while step < self.cfg.total_steps:
            if self.injector is not None:
                self.injector.maybe_fail(step)
            batch = self._batch(step)
            t0 = time.perf_counter()
            params, opt, m = self._step_fn(state["params"], state["opt"],
                                           batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            state = {"params": params, "opt": opt}
            self._watch_stragglers(dt)
            if self.is_writer and (step % self.cfg.log_every == 0
                                   or step == self.cfg.total_steps - 1):
                self.metrics_log.append(
                    {"step": step, "loss": float(m["loss"]),
                     "gnorm": float(m.get("gnorm", 0.0)), "sec": dt})
            if step % self.cfg.ckpt_every == 0 and step > 0:
                self._save(step, state)
            step += 1
        return step, state

    def _watch_stragglers(self, dt: float) -> None:
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            if dt > self.cfg.straggler_factor * med:
                self.stragglers += 1

    # ------------------------------------------------------------------ #
    def resume_elastic(self, new_stepper: Stepper,
                       shardings: Optional[Any] = None):
        """Restore the latest checkpoint onto another stepper, on this
        trainer's device, wherever it was written. ``shardings``: the
        placement of each leaf of ``{"params", "opt"}`` on the new mesh
        (each rank gets its blocks); for a stepper with a mesh it defaults
        to ``new_stepper.state_shardings()``, the blocks its train step
        takes. Returns (next step, state)."""
        if shardings is None and new_stepper.mesh is not None:
            shardings = new_stepper.state_shardings()
        self.ckpt.wait()
        self._sync()
        params = new_stepper.init(device=self.device)
        like = {"params": params, "opt": init_opt_state(params)}
        step, restored = self.ckpt.restore(like, shardings)
        return step + 1, restored
