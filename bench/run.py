"""The benchmark of ``repro_torch``: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<config>.json``, whose ``reference`` names its plain
reference under ``bench/reference/``) and a traffic mix
(``bench/traffic/<mix>.json``, with ``bench/cells/<cell>.json`` over it).
The run draws the weights and the traffic from ``--seed``, warms up on the
cell's shapes, serves the traffic through the program's ``Server`` for
``--seconds``, then judges a sample of what it served against the plain
reference. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
spans, stamps and a device trace of a fixed slice of the window.

The last line of standard output is the result (JSON); the last lines of
standard error give each number compared beside its limit. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits 2; if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import check, metrics, program, serve, spec, traffic  # noqa: E402
from bench.harness import weights as wts  # noqa: E402

#: top-level module names that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _same_shapes(layout: Dict, port: Dict, path: str = "") -> None:
    """The benchmark's weight layout is the port's parameter tree."""
    if set(layout) != set(port):
        raise ValueError(f"weights {path or '/'}: benchmark {sorted(layout)}"
                         f" vs program {sorted(port)}")
    for k in layout:
        if isinstance(layout[k], dict):
            _same_shapes(layout[k], port[k], f"{path}/{k}")
        elif tuple(layout[k][0]) != tuple(port[k]):
            raise ValueError(f"weights {path}/{k}: benchmark {layout[k][0]} "
                             f"vs program {port[k]}")


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            root: Path = spec.ROOT, bench: Optional[Dict] = None,
            server_cls=None, overlay: Optional[Dict] = None
            ) -> Tuple[Dict, list]:
    """One run on ``device``: (result, the numbers compared as lines)."""
    import torch

    cell = spec.load(workload, root, bench, overlay)
    config, mix = cell.config, cell.mix
    model = importlib.import_module(f"bench.reference.{config['reference']}")
    cfg = program.model_config(config)
    layout = model.layout(config)
    _same_shapes(layout, program.schema_shapes(cfg))
    params = wts.draw(layout, seed, torch.bfloat16, device)
    serve.warm_up(cfg, params, config, mix, device)
    reqs = traffic.generate(mix, seed, seconds, config["vocab_size"])
    run = serve.serve(cfg, params, config, mix, reqs, seconds, device,
                      trace=trace, server_cls=server_cls)
    reading = metrics.Reading(run=run, config=config, model=model)
    values = metrics.read(cell.per_layer if trace else cell.end_to_end,
                          reading)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        model.ieee_f32()
    verdict = check.judge(run, params, config, model, seed, mix, device)
    failed = check.failed(run, config["vocab_size"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": verdict.correct and failed == 0,
              "attempted": len(run.served), "failed": failed,
              "metrics": values, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["sample"] = {"requests": verdict.sampled,
                        "tokens": verdict.tokens}
    result["compared"] = {"widest_gap": {"value": verdict.widest_gap,
                                         "limit": verdict.limit},
                          "failed_requests": {"value": failed, "limit": 0}}
    lines = [f"compared widest_gap {verdict.widest_gap!r} limit "
             f"{verdict.limit!r}",
             f"compared failed_requests {failed} limit 0"]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible; nothing was run",
              file=sys.stderr)
        return 2
    result, lines = execute(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda")
    loaded = forbidden_loaded()             # the window has closed
    if loaded:
        print("bench: loaded in the measured process: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    result["card"] = _power_limit()
    compared = result.pop("compared")
    result["compared"] = compared           # the last key of the line
    print(f"bench: card {result['card']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
