"""Deterministic mixed-traffic load generator for the accelerator farm
(port of ``repro/serving/loadgen.py``).

Replays seeded heavy traffic — the ROADMAP's "millions of users" scaled to
a benchmarkable slice — against a farm built from the repo's two paper
workloads: the LSTM traffic predictor (``configs/elastic_lstm``) and the
conv1d sensor stack (``configs/elastic_conv1d``), each deployed at several
window lengths (the batcher's buckets) with ``--replicas`` pool members per
bucket, each an :class:`~repro_torch.rtl.backend.RTLExecutable` whose
emulator runs on ``--device`` (the card by default: every dispatch a CUDA
Graph replay of B1 and B2). The designs' params are drawn from a
``torch.Generator`` seeded by ``--seed``; requests draw design, window
length and window contents from one ``numpy`` generator seeded by
``--seed`` (the reference's tape, value for value), so a run is replayable
bit-for-bit; under an injected clock even the latency histograms replay
exactly (the determinism test).

Arrival modes:

* ``closed`` — submit a wave, drain it, repeat: bounded concurrency, the
  classic closed-loop throughput probe;
* ``open``  — submit the next wave every tick regardless of backlog: the
  bounded admission queue is the only brake, so overload shows up as
  shedding/expiry instead of latency creep.

Reported per design via the farm's ``serving.*`` histograms: p50/p99
latency, windows/s, and GOP/J — energy from the cycle-accurate model
(``resources.estimate`` × ``HWSpec.energy_j``), the same accounting the
measurement stage uses, so the figure is deterministic and comparable to
the paper's Table I.

CLI::

    python -m repro_torch.serving.loadgen --arch lstm,conv1d --requests 512 \
        --out report.json --p99-bound 0.5 [--device cpu]

Exits nonzero when a request admitted to the queue fails to reach
``done``/``expired`` (dropped after admission) or the p99 bound is blown.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.farm import AcceleratorFarm, DesignPool, FarmConfig
from repro_torch.serving.queue import DONE

Device = Optional[Union[str, torch.device]]

#: per-design input feature width (lstm is univariate, conv1d is 3-axis IMU)
ARCH_FEATURES = {"lstm": 1, "conv1d": 3}
#: default window-length buckets: each length is a separately lowered design
DEFAULT_BUCKETS: Dict[str, Tuple[int, ...]] = {
    "lstm": (6, 12), "conv1d": (16, 24)}


def _variant_cfg(arch: str, seq_len: int):
    """The paper workload's ModelConfig re-lowered at ``seq_len``."""
    if arch == "lstm":
        from repro_torch.configs.elastic_lstm import config

        cfg = config()
        return cfg.with_(lstm=dataclasses.replace(cfg.lstm,
                                                  seq_len=seq_len))
    if arch == "conv1d":
        from repro_torch.configs.elastic_conv1d import config

        cfg = config()
        return cfg.with_(conv1d=dataclasses.replace(cfg.conv1d,
                                                    seq_len=seq_len))
    raise ValueError(f"unknown arch {arch!r}; known: "
                     f"{sorted(ARCH_FEATURES)}")


def build_design(arch: str, seq_lens: Sequence[int], *, replicas: int = 2,
                 seed: int = 0, params: Optional[Callable] = None,
                 device: Device = None) -> DesignPool:
    """Lower ``arch`` once per window length and replicate each executable
    into a pool (``dataclasses.replace`` re-runs ``__post_init__`` — every
    replica owns a fresh emulator, i.e. its own program cache).

    ``params(cfg)`` gives the params of the variant ``cfg`` (a test feeds
    the reference's through ``convert.params_from_jax``); by default they
    are drawn from a ``torch.Generator`` seeded by ``seed``, afresh for
    each window length as the reference draws from one key."""
    from repro_torch.model.layers import init_params
    from repro_torch.rtl.backend import translate_rtl
    from repro_torch.rtl.resources import estimate

    members: Dict[int, List] = {}
    flops_d: Dict[int, float] = {}
    energy_d: Dict[int, float] = {}
    for seq_len in seq_lens:
        cfg = _variant_cfg(arch, seq_len)
        if arch == "lstm":
            from repro_torch.model.lstm import lstm_flops, lstm_schema

            schema, flops = lstm_schema(cfg), float(lstm_flops(cfg))
        else:
            from repro_torch.model.conv1d import conv1d_flops, conv1d_schema

            schema, flops = conv1d_schema(cfg), float(conv1d_flops(cfg))
        p = params(cfg) if params is not None else init_params(
            schema, torch.Generator().manual_seed(seed))
        _, exe = translate_rtl(cfg, p, model_flops=flops, device=device)
        rr = estimate(exe.graph, clock_hz=exe.hw.clock_hz or 100e6)
        members[seq_len] = [exe] + [dataclasses.replace(exe)
                                    for _ in range(max(0, replicas - 1))]
        flops_d[seq_len] = flops
        energy_d[seq_len] = exe.hw.energy_j(rr.latency_s, duty=rr.duty)
    return DesignPool(family=arch, members=members,
                      flops_per_window=flops_d,
                      energy_per_window_j=energy_d)


def build_farm(archs: Sequence[str], *, replicas: int = 2,
               buckets: Optional[Dict[str, Tuple[int, ...]]] = None,
               cfg: FarmConfig = FarmConfig(), seed: int = 0,
               clock=time.perf_counter,
               metrics: Optional[MetricsRegistry] = None,
               params: Optional[Callable] = None,
               device: Device = None
               ) -> Tuple[AcceleratorFarm, List[DesignPool]]:
    buckets = buckets if buckets is not None else DEFAULT_BUCKETS
    pools = [build_design(a, buckets[a], replicas=replicas, seed=seed,
                          params=params, device=device)
             for a in archs]
    return AcceleratorFarm(pools, cfg, clock=clock, metrics=metrics), pools


@dataclass(frozen=True)
class TrafficSpec:
    """One seeded traffic mix: what arrives, how fast, in which loop."""

    archs: Tuple[str, ...] = ("lstm", "conv1d")
    n_requests: int = 512
    wave: int = 64                   # requests submitted per round
    mode: str = "closed"             # "closed" | "open"
    seed: int = 0
    timeout_s: Optional[float] = None    # per-request deadline (open loop)

    def __post_init__(self):
        if self.mode not in ("closed", "open"):
            raise ValueError(f"mode must be 'closed' or 'open', "
                             f"got {self.mode!r}")
        if self.n_requests < 1 or self.wave < 1:
            raise ValueError("n_requests and wave must be >= 1")


def generate_requests(spec: TrafficSpec,
                      buckets: Dict[str, Tuple[int, ...]]
                      ) -> List[Tuple[str, np.ndarray]]:
    """The seeded request tape: ``(design, (T, F) float32 window)`` pairs
    with design mix, ragged window lengths, and contents all drawn from one
    generator — identical tape for identical ``spec``."""
    rng = np.random.default_rng(spec.seed)
    archs = sorted(spec.archs)
    out: List[Tuple[str, np.ndarray]] = []
    for _ in range(spec.n_requests):
        design = archs[int(rng.integers(len(archs)))]
        lens = buckets[design]
        t = int(rng.integers(max(1, min(lens) // 2), max(lens) + 1))
        window = rng.standard_normal(
            (t, ARCH_FEATURES[design])).astype(np.float32) * 0.25
        out.append((design, window))
    return out


def run_loadgen(farm: AcceleratorFarm, pools: Sequence[DesignPool],
                spec: TrafficSpec, *, clock=time.perf_counter) -> dict:
    """Drive one traffic tape through the farm; returns the stats report
    (a JSON-stable dict — identical spec + injected clock ⇒ identical
    report, the determinism contract)."""
    tape = generate_requests(
        spec, {p.family: p.window_lengths for p in pools})
    rid_start = farm._next_rid
    t0 = clock()
    if spec.mode == "closed":
        for i in range(0, len(tape), spec.wave):
            for design, window in tape[i:i + spec.wave]:
                farm.submit(design, window, timeout_s=spec.timeout_s)
            farm.run_until_drained()
    else:                            # open loop: submit every tick, no brake
        i = 0
        while i < len(tape) or len(farm.queue):
            for design, window in tape[i:i + spec.wave]:
                farm.submit(design, window, timeout_s=spec.timeout_s)
            i += spec.wave
            farm.tick(flush=i >= len(tape))
        farm.run_until_drained()
    elapsed = clock() - t0
    # a re-run on a warmed farm reports only ITS OWN requests (rid >=
    # rid_start): latency and throughput come from the request records,
    # not the farm-lifetime histograms, so steady-state runs aren't
    # polluted by an earlier pass's build-era tail.
    reqs = [r for rid, r in sorted(farm.requests.items())
            if rid >= rid_start]
    return _report(farm, pools, spec, reqs, elapsed)


def _report(farm: AcceleratorFarm, pools: Sequence[DesignPool],
            spec: TrafficSpec, reqs, elapsed_s: float) -> dict:
    from repro_torch.obs import percentile

    def lat_summary(rs) -> dict:
        lats = sorted(r.t_done - r.t_submit for r in rs
                      if r.status == DONE and r.t_done is not None)
        return {"count": len(lats),
                "p50": percentile(lats, 50), "p99": percentile(lats, 99),
                "max": lats[-1] if lats else 0.0}

    done = [r for r in reqs if r.status == DONE]
    by_status: Dict[str, int] = {}
    for r in reqs:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    lat = lat_summary(reqs)
    per_design = {}
    for pool in pools:
        mine = [r for r in reqs if r.design == pool.family]
        fin = [r for r in mine if r.status == DONE]
        flops = sum(pool.flops_per_window.get(r.bucket_len, 0.0)
                    for r in fin)
        energy = sum(pool.energy_per_window_j.get(r.bucket_len, 0.0)
                     for r in fin)
        per_design[pool.family] = {
            "submitted": len(mine),
            "done": len(fin),
            "window_lengths": list(pool.window_lengths),
            "latency_s": lat_summary(mine),
            "flops_dispatched": flops,
            "energy_j": energy,
            "gop_per_j": (flops / 1e9) / energy if energy else 0.0,
        }
    # zero-loss invariant (the serving gate): after a drain every request
    # is terminal — one stuck in ``queued`` was silently dropped.
    dropped = sum(1 for r in reqs if not r.terminal)
    return {
        "spec": dataclasses.asdict(spec),
        "submitted": len(reqs),
        "by_status": dict(sorted(by_status.items())),
        "elapsed_s": elapsed_s,
        "throughput_windows_per_s": (len(done) / elapsed_s
                                     if elapsed_s > 0 else None),
        "latency_p50_s": lat["p50"],
        "latency_p99_s": lat["p99"],
        "dropped_after_admission": dropped,
        "stats": farm.stats().to_dict(),
        "per_design": per_design,
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The CLI's flags: the reference's, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.loadgen",
        description="seeded mixed-traffic loadgen for the accelerator farm")
    p.add_argument("--arch", default="lstm,conv1d",
                   help="comma-separated design families "
                        f"(known: {sorted(ARCH_FEATURES)})")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--wave", type=int, default=64)
    p.add_argument("--mode", default="closed", choices=("closed", "open"))
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--timeout-s", type=float, default=None)
    p.add_argument("--out", default=None,
                   help="write the stats report JSON here")
    p.add_argument("--p99-bound", type=float, default=None,
                   help="fail (exit 1) when p99 latency exceeds this")
    p.add_argument("--baseline", action="store_true",
                   help="also run the same tape unbatched (max_batch=1) "
                        "and report the batching speedup")
    p.add_argument("--device", default=None,
                   help="where the designs' emulators run: cuda (the "
                        "default; raises without CUDA) or cpu")
    p.add_argument("--warm", action="store_true",
                   help="run the tape once unreported first so every "
                        "(B, L, F) program is built — the reported pass "
                        "then measures steady state, not captures")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[dict, AcceleratorFarm]:
    """What the CLI runs: the report of the reported pass and the farm
    that served it (``--warm`` serves the tape once unreported first)."""
    archs = tuple(a.strip() for a in args.arch.split(",") if a.strip())
    spec = TrafficSpec(archs=archs, n_requests=args.requests,
                       wave=args.wave, mode=args.mode, seed=args.seed,
                       timeout_s=args.timeout_s)

    def one_run(max_batch: int, pad_batch: bool):
        farm, pools = build_farm(
            archs, replicas=args.replicas, seed=args.seed,
            cfg=FarmConfig(max_batch=max_batch, pad_batch=pad_batch),
            metrics=MetricsRegistry(), device=args.device)
        if args.warm:                # build pass; its requests unreported
            run_loadgen(farm, pools, spec)
        return run_loadgen(farm, pools, spec), farm

    report, farm = one_run(args.max_batch, True)
    if args.baseline:
        base, _ = one_run(1, False)
        report["unbatched"] = {
            "throughput_windows_per_s": base["throughput_windows_per_s"],
            "latency_p99_s": base["latency_p99_s"],
        }
        tput, base_tput = (report["throughput_windows_per_s"],
                           base["throughput_windows_per_s"])
        report["batching_speedup"] = (tput / base_tput
                                      if tput and base_tput else None)
    return report, farm


def summary(report: dict) -> List[str]:
    """The CLI's printed lines for ``report``."""
    st = report["by_status"]
    lines = [f"loadgen: {report['submitted']} submitted, "
             f"{st.get('done', 0)} done, {st.get('shed', 0)} shed, "
             f"{st.get('expired', 0)} expired, {st.get('failed', 0)} failed "
             f"over {report['stats']['dispatches']} dispatches"]
    tput = report["throughput_windows_per_s"]
    lines.append(f"  throughput: {tput:,.0f} windows/s" if tput
                 else "  throughput: n/a")
    lines.append(f"  latency p50/p99: {report['latency_p50_s'] * 1e6:.0f} / "
                 f"{report['latency_p99_s'] * 1e6:.0f} us")
    for fam, d in sorted(report["per_design"].items()):
        lines.append(f"  {fam}: {d['done']} done, "
                     f"{d['gop_per_j']:.2f} GOP/J")
    if report.get("batching_speedup") is not None:
        lines.append(f"  batching speedup vs unbatched: "
                     f"{report['batching_speedup']:.1f}x")
    return lines


def failures(report: dict, p99_bound: Optional[float] = None) -> List[str]:
    """Why the CLI exits 1: requests dropped after admission, failed
    requests, or p99 latency above ``p99_bound``; empty when it passes."""
    out = []
    st = report["by_status"]
    if report["dropped_after_admission"] != 0:
        out.append(f"{report['dropped_after_admission']} requests dropped "
                   "after admission")
    if st.get("failed", 0) != 0:
        out.append(f"{st['failed']} requests failed")
    if p99_bound is not None and report["latency_p99_s"] > p99_bound:
        out.append(f"p99 latency {report['latency_p99_s']:.4f}s exceeds "
                   f"bound {p99_bound}s")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    report, _ = run(args)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    for line in summary(report):
        print(line)
    bad = failures(report, args.p99_bound)
    for why in bad:
        print(f"FAIL: {why}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
