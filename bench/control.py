"""The readings a cell's limit is set from: for each seed, the program's
widest gap (a short window at the cell's own load, judged as a run judges
it) and the control's, the reference computed with float8 products put in
the program's place, read at the same prompts and served tokens.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

One process, one line a seed. The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import check, program, serve, spec, traffic  # noqa: E402
from bench.harness import weights as wts  # noqa: E402


def readings(workload: str, seeds: Iterable[int], seconds: float, device,
             root: Path = spec.ROOT, bench: Optional[Dict] = None,
             overlay: Optional[Dict] = None, server_cls=None):
    """Yields ``{"seed", "program_gap", "control_gap", ...}`` a seed."""
    import torch

    cell = spec.load(workload, root, bench, overlay)
    config, mix = cell.config, cell.mix
    model = importlib.import_module(f"bench.reference.{config['reference']}")
    cfg = program.model_config(config)
    for seed in seeds:
        params = wts.draw(model.layout(config), seed, torch.bfloat16, device)
        serve.warm_up(cfg, params, config, mix, device)
        reqs = traffic.generate(mix, seed, seconds, config["vocab_size"])
        run = serve.serve(cfg, params, config, mix, reqs, seconds, device,
                          server_cls=server_cls)
        if torch.device(device).type == "cuda":
            model.ieee_f32()
        v = check.judge(run, params, config, model, seed, mix, device,
                        control=True)
        yield {"seed": seed, "program_gap": v.widest_gap,
               "control_gap": v.control_gap, "limit": v.limit,
               "requests": v.sampled, "tokens": v.tokens,
               "failed": check.failed(run, config["vocab_size"])}
        del params, run
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.seconds, "cuda"):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
