"""Finds an open-loop cell's knee: the highest arrival rate whose queue does
not grow through a window.

    python3 bench/sweep.py --workload <cell> --rates 1.1,1.4,1.7 \\
        --seconds 51 --seeds <n>,<m>

One process, for each seed, draws the weights and warms up once, then
serves one window at each rate (a fresh server each, the cell's traffic
with its rate replaced) and prints a line a rate: time to first token at
p50 and p90, the backlog (requests due and not yet given a first token)
averaged over each half of the window, the slope of time to first token
against due time, and the gaps between tokens at p95 with how many
prefills stalled each gap. A queue that grows shows as a second half's
backlog well above the first's and a rising slope. The cell's file keeps
the rate chosen (0.8 of the knee); this script only finds it again.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import program, serve, spec, stats, traffic  # noqa: E402
from bench.harness import weights as wts  # noqa: E402


def backlog(run, t: float) -> int:
    return sum(1 for s in run.served if s.due <= t
               and not (s.stamps and s.stamps[0] <= t))


def stalls(run) -> dict:
    """Gaps between tokens by the number of first tokens (prefills) that
    fell inside them: their count and median (ms), and p95 of all."""
    t0, t1 = run.t0, run.t1
    firsts = np.sort([s.stamps[0] for s in run.served if s.stamps])
    by = {}
    for s in run.served:
        inside = [t for t in s.stamps if t0 <= t <= t1]
        for a, b in zip(inside, inside[1:]):
            k = int(np.searchsorted(firsts, b) - np.searchsorted(firsts, a,
                                                                 "right"))
            by.setdefault(min(k, 3), []).append(b - a)
    out = {f"gaps_{k}_prefills": [len(v), round(1e3 * float(np.median(v)), 1)]
           for k, v in sorted(by.items())}
    every = [g for v in by.values() for g in v]
    if every:
        out["itl_p95_ms"] = 1e3 * stats.percentile(every, 95)
    return out


def trend(run) -> dict:
    """The window's queue: backlog means over each half, and the slope of
    time to first token against due time (ms per s)."""
    t0, t1 = run.t0, run.t1
    grid = np.linspace(t0, t1, 61)
    b = [backlog(run, t) for t in grid]
    due = [s.due for s in run.served if t0 <= s.due <= t1]
    ttft = stats.ttfts(due, [next((s.stamps[0] for s in run.served
                                   if s.due == d and s.stamps), None)
                             for d in due], t0, t1)
    slope = float(np.polyfit(np.array(due) - t0, ttft, 1)[0]) * 1e3 \
        if len(due) > 2 else float("nan")
    return {"ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
            "backlog_first_half": float(np.mean(b[:30])),
            "backlog_second_half": float(np.mean(b[31:])),
            "ttft_slope_ms_per_s": slope, "requests": len(due),
            **stalls(run)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", default="1",
                    help="seeds, comma-separated: a sweep for each")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    config, mix = cell.config, cell.mix
    if mix["loop"] != "open":
        print("sweep: only an open loop has a knee", file=sys.stderr)
        return 2
    model = importlib.import_module(f"bench.reference.{config['reference']}")
    cfg = program.model_config(config)
    for seed in (int(s) for s in args.seeds.split(",")):
        params = wts.draw(model.layout(config), seed, torch.bfloat16, "cuda")
        serve.warm_up(cfg, params, config, mix, "cuda")
        for rate in (float(r) for r in args.rates.split(",")):
            m = dict(mix, rate_per_s=rate)
            reqs = traffic.generate(m, seed, args.seconds,
                                    config["vocab_size"])
            run = serve.serve(cfg, params, config, m, reqs, args.seconds,
                              "cuda")
            print(json.dumps({"seed": seed, "rate_per_s": rate,
                              **trend(run)}), flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
