"""Training launcher (port of ``repro/launch/train.py``; the same flags
plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --steps 200 [--full] [--seq 256] [--batch 16] [--ckpt-dir DIR] \
        [--device cpu]

Trains the arch's smoke config (``--full``: its published widths and
depth) from seeded random parameters on one device with the fault-tolerant
``Trainer``: async checkpoints, restore and deterministic replay included.
Attention goes through kernel B5 (its plain version on the CPU). Without
``--device`` it runs on CUDA or raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--production", action="store_true",
                    help="the 16x16 production mesh (comes with the "
                    "multi-GPU slice)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the two-pod mesh (comes with the multi-GPU slice)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--scan", action="store_true",
                    help="accepted for the reference's command lines; the "
                    "port runs eagerly, so there is no compile time to save,"
                    " and scan and unroll compute the same numbers")
    ap.add_argument("--compute-dtype", default=None,
                    help="override (default bf16 on CUDA, f32 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    return _run(args)


def _run(args) -> int:
    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig
    from repro_torch.device import resolve_device
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    if args.production or args.multi_pod:
        raise NotImplementedError(
            "--production and --multi-pod build a multi-device mesh, which "
            "comes with the multi-GPU slice (ROADMAP A11: launch/mesh.py and "
            "shardmap.py as torch.distributed)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    dtype = args.compute_dtype or (
        "bfloat16" if device.type == "cuda" else "float32")
    par = ParallelismConfig(compute_dtype=dtype, attn_impl="flash")
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    st = Stepper(cfg, shape, SMOKE_MESH, par,
                 opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                     warmup_steps=max(10, args.steps // 20)))
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    tr = Trainer(st, dcfg,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10),
                 device=device)
    out = tr.train()
    for m in out["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['gnorm']:.3f}  {m['sec']*1e3:.0f} ms")
    print(f"done: {out['steps']} steps, {out['recoveries']} recoveries, "
          f"{out['stragglers']} straggler steps ({device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
