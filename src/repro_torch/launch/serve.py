"""Serving launcher: batched generation with the continuous-batching server
(port of ``repro/launch/serve.py``; the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --requests 8

Serves the arch's smoke config with seeded random weights, as the
reference does; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.model.lm import Stepper
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = get_config(args.arch, smoke=True)
    par = ParallelismConfig(compute_dtype="float32")
    st = Stepper(cfg, ShapeConfig("p", "prefill", 32, 1), SMOKE_MESH, par)
    params = st.init(device=args.device)
    srv = Server(cfg, params,
                 ServerConfig(batch_slots=args.slots, max_len=args.max_len,
                              eos_token=-1, temperature=args.temperature),
                 SMOKE_MESH, par, device=args.device)
    t0 = time.perf_counter()
    for i in range(args.requests):
        srv.submit(list(range(3 + i, 19 + i)), max_new_tokens=args.max_new)
    reqs = srv.run_until_drained()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: {r.out_tokens}")
    print(f"{len(reqs)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, {args.slots} slots, {srv.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
