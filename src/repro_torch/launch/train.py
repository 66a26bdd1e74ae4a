"""Training launcher (port of ``repro/launch/train.py``; the same flags
plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --steps 200 [--full] [--seq 256] [--batch 16] [--ckpt-dir DIR] \
        [--scan] [--device cpu]

Trains the arch's smoke config (``--full``: its published widths and
depth) from seeded random parameters with the fault-tolerant ``Trainer``:
async checkpoints, restore and deterministic replay included. Attention
goes through kernel B5 (its plain version on the CPU). Without
``--device`` it runs on CUDA or raises. ``--scan`` runs the layer stack in
its scan-over-layers form (``ParallelismConfig.scan_layers``), whose losses
are the unrolled form's. ``--production`` (``--multi-pod``) trains on the
16 x 16 (2 x 16 x 16) mesh of ``launch/mesh.py`` over the process group
the caller initialised (every rank runs this launcher); without one of
256 (512) ranks it raises ``make_production_mesh``'s RuntimeError.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--production", action="store_true",
                    help="build the 16x16 production mesh (needs an "
                    "initialised process group of 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--scan", action="store_true",
                    help="scan-over-layers: each group's stacked layers as "
                    "one scan (zamba2 remats a unit of layers and the shared"
                    " block at a time); the losses are the unrolled form's")
    ap.add_argument("--compute-dtype", default=None,
                    help="override (default bf16 on CUDA, f32 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return _run(parse_args(argv))


def run(args) -> dict:
    """Train as ``args`` (:func:`parse_args`) say; returns the
    ``Trainer.train`` result and the device it ran on."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_production_mesh, mesh_config
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    if args.production:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
        mcfg = mesh_config(multi_pod=args.multi_pod)
    else:
        mesh, mcfg = None, SMOKE_MESH
    cfg = get_config(args.arch, smoke=args.smoke)
    dtype = args.compute_dtype or (
        "bfloat16" if device.type == "cuda" else "float32")
    par = ParallelismConfig(compute_dtype=dtype, scan_layers=args.scan,
                            attn_impl="flash")
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    st = Stepper(cfg, shape, mcfg, par, mesh=mesh,
                 opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                     warmup_steps=max(10, args.steps // 20)))
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    tr = Trainer(st, dcfg,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10),
                 device=device)
    return dict(tr.train(), device=device)


def _run(args) -> int:
    out = run(args)
    for m in out["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['gnorm']:.3f}  {m['sec']*1e3:.0f} ms")
    print(f"done: {out['steps']} steps, {out['recoveries']} recoveries, "
          f"{out['stragglers']} straggler steps ({out['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
