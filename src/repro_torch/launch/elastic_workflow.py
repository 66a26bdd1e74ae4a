"""The paper's demo, as a launcher: the full ElasticAI-Workflow on an edge
workload — design/train -> translate+estimate -> deploy+measure, with the
feedback loop widening the fixed-point format until the requirement is met
(port of ``examples/elastic_workflow.py``).

    PYTHONPATH=src python -m repro_torch.launch.elastic_workflow --verify
    PYTHONPATH=src python -m repro_torch.launch.elastic_workflow --arch conv1d
    PYTHONPATH=src python -m repro_torch.launch.elastic_workflow --target rtl
    PYTHONPATH=src python -m repro_torch.launch.elastic_workflow \\
        --device cpu --train-steps 2 --max-iters 1

``--arch`` picks the workload: the paper's traffic-flow LSTM (QAT-trained)
or the TCN-style depthwise conv1d sensor stack. Stage 1 trains on
``--device`` (default: CUDA, raising without it). ``--target`` picks where
stages 2 and 3 run: the host target ``xla`` (the default, as in the
reference) counts the batch-1 step's torch program for its roofline and
8-channel estimate and times the step on the device; ``rtl`` runs them
against the *generated accelerator*: template artifacts are emitted and the
bit-exact emulator, on the same device (kernels B1 and B2 on CUDA), runs
the design while its cycle schedule provides the measurement. Whatever the
target, the script finishes by "pressing the button" — translating the
final design to RTL artifacts (written to ``--build-dir`` when given).

``--chaos PLAN_JSON`` (with ``--target rtl``) then runs a scripted chaos
scenario against that final RTL deployment: the fault plan is injected
under a guarded wrapper (canary, breaker, RTL→host fallback) and scored on
the golden vectors; ``resilience.json`` lands in the ``--build-dir``
bundle, and the run exits non-zero unless the fault is detected and
traffic recovers with no corrupted answer after detection. ``--trace``
captures the whole run (spans and metrics, ``repro_torch.obs.capture``).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from typing import Optional, Union

import torch

from repro_torch.configs import get_config
from repro_torch.core.creator import Creator
from repro_torch.core.report import DesignReport
from repro_torch.core.target import get_target, list_targets
from repro_torch.core.types import shape_table_for, shapes_for
from repro_torch.core.workflow import Requirement, Workflow, chaos_fallback
from repro_torch.data.pipeline import (SensorConfig, TrafficConfig,
                                       sensor_window_batch,
                                       traffic_flow_batch)
from repro_torch.device import resolve_device
from repro_torch.energy.hw import XC7S15
from repro_torch.model.conv1d import (conv1d_apply, conv1d_flops,
                                      conv1d_schema)
from repro_torch.model.layers import (init_params, tree_leaves,
                                      value_and_grad)
from repro_torch.model.lstm import lstm_flops, lstm_schema
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.quant.qat import (QATConfig, fake_quant_tree,
                                   make_qat_loss, make_qat_lstm_apply)

Device = Optional[Union[str, torch.device]]

TRAIN_STEPS = 120
TRAIN_BATCH = 256
OPT = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=150,
                  weight_decay=0.0)
REQUIREMENT = Requirement(max_eval_loss=0.01, max_latency_s=1.0)

ARCH_ALIASES = {"lstm": "elastic-lstm", "conv1d": "elastic-conv1d"}


def _on(batch, device: torch.device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _init(schema, device: torch.device):
    """Initial parameters drawn on ``device`` by a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return init_params(schema, gen)


def train(loss_fn, params, batch, steps: int):
    """``steps`` AdamW steps (``OPT``) of ``loss_fn(params, batch)`` on one
    batch; returns (params, the loss before each step as a tensor)."""
    grad_fn = value_and_grad(loss_fn)
    opt = init_opt_state(params)
    losses = []
    for _ in range(steps):
        loss, grads = grad_fn(params, batch)
        params, opt, _ = adamw_update(grads, opt, params, OPT)
        losses.append(loss.detach())
    return params, torch.stack(losses)


def _qat_cfg(knobs, hard: bool = True) -> QATConfig:
    return QATConfig(weight_fmt=FxpFormat(knobs["bits"], knobs["frac"]),
                     act_fmt=FxpFormat(knobs["bits"],
                                       max(0, knobs["frac"] - 2)),
                     hard_activations=hard)


def lstm_train_fn(knobs, *, device: Device = None, steps: int = TRAIN_STEPS,
                  params=None):
    """Stage 1 for the paper's LSTM: QAT in the knobs' formats, from
    ``params`` (default: drawn on ``device``)."""
    dev = resolve_device(device)
    cfg = get_config("elastic-lstm")
    qcfg = _qat_cfg(knobs, knobs.get("hard_act", True))
    if params is None:
        params = _init(lstm_schema(cfg), dev)
    loss_fn = make_qat_loss(cfg, qcfg)
    batch = _on(traffic_flow_batch(TrafficConfig(batch=TRAIN_BATCH), 0), dev)
    params, losses = train(lambda p, b: loss_fn(p, b)[0], params, batch,
                           steps)
    ev = _on(traffic_flow_batch(TrafficConfig(batch=TRAIN_BATCH, seed=9), 1),
             dev)
    apply = make_qat_lstm_apply(cfg, qcfg)
    with torch.no_grad():
        pred, _ = apply(params, ev["x"])
        eval_loss = float(torch.mean((pred - ev["y"]) ** 2))
    rep = DesignReport(model="elastic-lstm", train_loss=float(losses[-1]),
                       eval_loss=eval_loss,
                       params=sum(p.numel() for p in tree_leaves(params)),
                       weight_fmt=str(qcfg.weight_fmt),
                       act_fmt=str(qcfg.act_fmt))
    return params, rep, apply


def lstm_step_builder(knobs, params, *, device: Device = None):
    cfg = get_config("elastic-lstm")
    apply = make_qat_lstm_apply(cfg, _qat_cfg(knobs))
    x = torch.as_tensor(traffic_flow_batch(TrafficConfig(batch=1), 0)["x"],
                        device=resolve_device(device))
    return (lambda p, xx: apply(p, xx)[0]), (params, x), \
        float(lstm_flops(cfg))


def conv1d_train_fn(knobs, *, device: Device = None,
                    steps: int = TRAIN_STEPS, params=None):
    """Stage 1 for the sensor stack: the hard activations are already in
    the float graph, so QAT is just fake-quantizing the weights to the
    knobs' format (straight-through) — widening the knobs genuinely moves
    the reported eval loss, which is what the feedback loop reads."""
    dev = resolve_device(device)
    cfg = get_config("elastic-conv1d")
    c = cfg.conv1d
    wfmt = FxpFormat(knobs["bits"], knobs["frac"])
    if params is None:
        params = _init(conv1d_schema(cfg), dev)
    batch = _on(sensor_window_batch(SensorConfig(
        seq_len=c.seq_len, channels=c.channels, batch=TRAIN_BATCH), 0), dev)

    def loss_fn(p, b):
        pred, _ = conv1d_apply(fake_quant_tree(p, wfmt), b["x"], cfg)
        return torch.mean((pred - b["y"]) ** 2)

    params, losses = train(loss_fn, params, batch, steps)
    ev = _on(sensor_window_batch(SensorConfig(
        seq_len=c.seq_len, channels=c.channels, batch=TRAIN_BATCH, seed=9),
        1), dev)
    with torch.no_grad():
        eval_loss = float(loss_fn(params, ev))
    rep = DesignReport(model="elastic-conv1d", train_loss=float(losses[-1]),
                       eval_loss=eval_loss,
                       params=sum(p.numel() for p in tree_leaves(params)),
                       weight_fmt=str(wfmt), act_fmt=str(
                           FxpFormat(knobs["bits"],
                                     max(0, knobs["frac"] - 2))))
    return params, rep, None


def conv1d_step_builder(knobs, params, *, device: Device = None):
    cfg = get_config("elastic-conv1d")
    c = cfg.conv1d
    x = torch.as_tensor(sensor_window_batch(
        SensorConfig(seq_len=c.seq_len, channels=c.channels, batch=1),
        0)["x"], device=resolve_device(device))
    return ((lambda p, xx: conv1d_apply(p, xx, cfg)[0]), (params, x),
            float(conv1d_flops(cfg)))


BUILDERS = {
    "elastic-lstm": (lstm_train_fn, lstm_step_builder),
    "elastic-conv1d": (conv1d_train_fn, conv1d_step_builder),
}


def optimizer(history):
    """The feedback rule a developer would apply after reading the reports:
    eval loss too high -> widen the fixed-point format."""
    k = dict(history[-1].knobs)
    print(f"  [feedback] eval_loss={history[-1].design.eval_loss:.4f} "
          f"with {history[-1].design.weight_fmt} -> widening")
    if k["bits"] >= 16:
        return None
    k["bits"] += 4
    k["frac"] += 3
    return k


def build_workflow(arch: str, *, device: Device = None, verify: bool = False,
                   train_steps: int = TRAIN_STEPS,
                   target: str = "xla") -> Workflow:
    """The workflow of ``arch`` on ``device`` for ``target``, with the
    example's settings: stage 1 trains there and the deployment runs
    there, the host target's step or the RTL design's emulator. Only
    ``rtl`` lowers a stepper, on the XC7S15, with the static verifier
    gating at ``"error"``."""
    dev = resolve_device(device)
    rtl = target == "rtl"
    creator = Creator(hw=XC7S15, device=dev) if rtl else Creator(device=dev)
    train_fn, step_builder = BUILDERS[arch]
    return Workflow(
        creator=creator,
        train_fn=functools.partial(train_fn, device=dev, steps=train_steps),
        step_builder=functools.partial(step_builder, device=dev),
        stepper_builder=functools.partial(_stepper, creator, arch)
        if rtl else None,
        target=target, verify=verify, analyze="error" if rtl else None)


def _stepper(creator: Creator, arch: str, knobs=None):
    """The batch-1 inference stepper of ``arch`` (shape ``infer_1``)."""
    cfg = get_config(arch)
    return creator.build(cfg, shape_table_for(cfg)[shapes_for(cfg)[0]])


def chaos_spec(plan_path: str):
    """The launcher's chaos scenario: the plan at ``plan_path``, 24
    requests, the plan's seed and the reference launcher's guard policy."""
    from repro_torch.resilience import ChaosSpec, FaultPlan, GuardPolicy

    plan = FaultPlan.load(plan_path)
    return ChaosSpec(plan=plan, n_requests=24, seed=plan.seed,
                     policy=GuardPolicy(timeout_s=0.25, max_retries=2,
                                        breaker_threshold=3,
                                        canary_every=4))


def run_chaos_stage(dep, plan_path: str):
    """:func:`chaos_spec` against the final RTL deployment ``dep``, with
    the float oracle of its graph as the ``"xla"`` fallback on its
    device."""
    from repro_torch.resilience import run_chaos

    return run_chaos(dep, chaos_spec(plan_path),
                     fallback=chaos_fallback(dep, XC7S15))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", "--backend", dest="target",
                    choices=list_targets(), default="xla",
                    help="registered deployment target (--backend is the "
                         "legacy spelling)")
    ap.add_argument("--arch", default="lstm",
                    choices=sorted(set(ARCH_ALIASES) | set(BUILDERS)),
                    help="workload: the paper's LSTM or the conv1d sensor "
                         "stack (short or full arch id)")
    ap.add_argument("--max-iters", type=int, default=4,
                    help="feedback-loop budget (a smoke run uses 1)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="stage-1 training steps per iteration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--build-dir", default=None,
                    help="write the final RTL artifact bundle here "
                         "(<build-dir>/<arch>/)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="capture the whole run (spans + metrics) and write "
                         "Chrome trace-event JSON here — open it in Perfetto "
                         "or chrome://tracing; the full RunTrace bundle "
                         "(trace.jsonl, metrics.json, summary.txt) lands "
                         "next to it, and a copy goes into the --build-dir "
                         "bundle when given")
    ap.add_argument("--verify", action="store_true",
                    help="run the Elastic Node conformance stage: "
                         "Deployment.verify after every loop measurement, "
                         "plus a full differential check + golden vectors "
                         "for the final RTL design (reports land in "
                         "<build-dir>/<arch>/ when given)")
    ap.add_argument("--chaos", default=None, metavar="PLAN_JSON",
                    help="run a scripted chaos scenario against the final "
                         "RTL deployment: the FaultPlan JSON is injected "
                         "under a guarded wrapper (canary + breaker + "
                         "RTL->host fallback) and scored on the golden "
                         "vectors; exits non-zero unless the fault is "
                         "detected and traffic recovers with zero "
                         "post-detection corruption (resilience.json "
                         "lands in <build-dir>/<arch>/ when given); "
                         "see examples/chaos_plan.json")
    args = ap.parse_args(argv)
    if args.chaos and args.target != "rtl":
        ap.error("--chaos models SEUs in the generated accelerator; "
                 "use --target rtl")
    arch = ARCH_ALIASES.get(args.arch, args.arch)
    dev = resolve_device(args.device)

    cap = None
    if args.trace:
        from repro_torch.obs import capture

        cap = capture(f"elastic-workflow[{arch}:{args.target}]")
        cap.__enter__()                  # closed (and written) at the end

    cfg = get_config(arch)
    wf = build_workflow(arch, device=dev, verify=args.verify,
                        train_steps=args.train_steps, target=args.target)
    hist = wf.run(REQUIREMENT, optimizer, {"bits": 4, "frac": 2},
                  max_iters=args.max_iters)
    print(f"\n{'it':>3} {'fmt':>7} {'eval':>8} {'est_ms':>8} {'meas_ms':>8} "
          f"{'est_uJ':>8} {'GOP/J':>7} {'vrfy':>4} {'ok':>3}")
    for r in hist:
        vrfy = "-" if r.conformance is None else \
            ("Y" if r.conformance.passed else "FAIL")
        print(f"{r.iteration:>3} {r.design.weight_fmt:>7} "
              f"{r.design.eval_loss:8.4f} "
              f"{r.synthesis.est_latency_s*1e3:8.3f} "
              f"{r.measurement.latency_s*1e3:8.3f} "
              f"{r.synthesis.est_energy_j*1e6:8.2f} "
              f"{r.measurement.gop_per_j:7.2f} "
              f"{vrfy:>4} "
              f"{'Y' if r.satisfied else 'n':>3}")
    print("\nworkflow finished:",
          "requirement met" if hist[-1].satisfied else "budget exhausted")

    # --- "press the button": translate the final design to RTL ----------- #
    best = hist[-1].knobs
    params, _, _ = wf.train_fn(best)
    rtl = get_target("rtl")
    creator_rtl = Creator(hw=XC7S15, device=dev)
    syn, dep = creator_rtl.translate(_stepper(creator_rtl, arch),
                                     target=rtl, params=params,
                                     options=rtl.options_from_knobs(best))
    if hist[-1].analysis is not None:
        print(f"\nstatic analysis: {hist[-1].analysis.summary()}")
    print(f"\nRTL translate [{arch}]: {syn.n_artifacts} artifacts, "
          f"{syn.resources['cycles']} cycles "
          f"({syn.est_latency_s*1e6:.2f} us @ 100 MHz), "
          f"dsp={syn.resources['dsp']} bram36={syn.resources['bram36']} "
          f"lut={syn.resources['lut']}, fits={syn.fits}")
    for name in sorted(dep.artifacts):
        print(f"  - {name}")
    out = None
    if args.build_dir:
        out = os.path.join(args.build_dir, arch)
        dep.save(out)
        print(f"artifact bundle written to {out}/")

    # --- Elastic Node conformance of the final design -------------------- #
    if args.verify:
        from repro_torch.verify import generate_vectors, save_vectors

        flops = float(lstm_flops(cfg) if cfg.family == "lstm"
                      else conv1d_flops(cfg))
        rep = dep.verify(model=cfg.name, model_flops=flops)
        print(f"\nconformance: {rep.summary()}")
        for note in rep.notes:
            print(f"  note: {note}")
        if out is not None:
            with open(os.path.join(out, "conformance.json"), "w") as f:
                f.write(rep.to_json())
            save_vectors(generate_vectors(dep.graph, device=dev),
                         os.path.join(out, "vectors"))
            print(f"ConformanceReport + golden vectors written to {out}/")
        if not rep.passed:
            raise SystemExit("conformance FAILED — see report above")

    # --- scripted chaos: fault-inject the deployed accelerator ----------- #
    if args.chaos:
        resil = run_chaos_stage(dep, args.chaos)
        print(f"\n{resil.summary()}")
        for f in resil.faults_injected:
            print(f"  injected: {f}")
        for d in resil.faults_detected:
            print(f"  detected: {d}")
        if out is not None:
            resil.save(os.path.join(out, "resilience.json"))
            print(f"ResilienceReport written to {out}/resilience.json")
        if not resil.passed:
            raise SystemExit(
                "chaos scenario FAILED: detected="
                f"{resil.detected} recovered={resil.recovered} "
                "corrupted_after_detection="
                f"{resil.corrupted_after_detection}")

    # --- write the captured trace ---------------------------------------- #
    if cap is not None:
        cap.__exit__(None, None, None)
        rt = cap.trace
        trace_path = os.path.abspath(args.trace)
        paths = rt.save(os.path.dirname(trace_path) or ".")
        if trace_path != paths["trace.json"]:    # honor a custom filename
            with open(trace_path, "w") as f:
                json.dump(rt.chrome(), f, indent=2, sort_keys=True)
        if out is not None:                      # copy into the RTL bundle
            rt.save(out)
        print(f"\n{rt.summary()}")
        print(f"\nChrome trace written to {args.trace} "
              "(open in Perfetto / chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
