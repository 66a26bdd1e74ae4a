#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Drives the port's main path — the Elastic Node's bit-exact integer emulator
on the paper's Table-I design ``elastic-lstm`` (and on ``elastic-conv1d``)
— through the kernels written for Hopper, and checks every answer:

1. build every kernel from ``src/repro_torch/csrc/`` (``nvcc``, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, exact
   integer equality, at the test shapes and at the serving shapes;
3. replay both checked-in golden vector sets in the three emulator modes;
4. serve ragged requests through ``RTLEmulator.run_many`` in ``fused`` mode,
   one design at a time (kernel launch counts are set to 0 just before each
   design's ``run_many`` and read just after it, and must equal one launch
   per node the kernel serves), each answer held against its solo run, the
   plain path and the float oracle; the kernels line carries the counts of
   the main path, ``elastic-lstm``;
5. time each kernel and its plain version at the serving shape (CUDA
   events around CUDA-graph replays), the emulator's windows/s, and the
   device busy share of one emulator run (``torch.profiler``);
6. print the kernels line and the card's name and power limit.

Usage, from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card and ``nvcc``; exits non-zero, printing no result, without them. The
last line of output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "vectors")
SEED = 0
B_SERVE = 65536                        # windows per serving batch
LSTM_REQUESTS = (1, 3, 7, 64, 255, 1024, 4096, 65536)
CONV_REQUESTS = (1, 5, 33, 1000, 8192)
# Peaks of one H100 SXM (NVIDIA's data sheet, full 700 W power limit):
# HBM3 at 3.35 TB/s; int32 multiply-add at 64 IMAD per clock per SM (half
# the FFMA rate behind the 67 TFLOP/s float32 figure: 132 SMs x 128 FFMA x
# 2 flops x 1.98 GHz), i.e. 132 x 64 x 1.98e9 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
INT32_MAC_PER_S = 132 * 64 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got, want) -> int:
    """Exact check: raises on any mismatch; returns the max |error| (0)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"kernel != plain version, max |err| {err}")
    return err


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: CUDA events around replays of a CUDA
    graph holding ``reps`` calls (no host launch gaps), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # warm the allocator's pool
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def profile_ms(fn):
    """One ``fn()`` under ``torch.profiler``: host-clock ms of the run
    (profiler on), and the device time of each GPU activity (kernels,
    copies) by name, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return wall * 1e3, device


def bound_ms(n_bytes: int, n_macs: int):
    """Least time on the card: bytes over HBM rate vs MACs over the int32
    IMAD rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_macs / INT32_MAC_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rand_codes(rng, fmt, shape):
    import torch

    return torch.as_tensor(rng.integers(fmt.lo, fmt.hi + 1, shape),
                           dtype=torch.int32, device="cuda")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                                   lstm_window_int_cuda,
                                                   lstm_window_int_ref)
    from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
    from repro_torch.kernels.mac_int import (mac_int_cuda, mac_int_op,
                                             mac_int_ref)
    from repro_torch.kernels.mac_int import ops as mac_ops
    from repro_torch.model.conv1d import conv1d_frames
    from repro_torch.quant.fixedpoint import FxpFormat
    from repro_torch.rtl.emulator import RTLEmulator, assert_bit_exact
    from repro_torch.rtl.oplib import requant_shift
    from repro_torch.verify.vectors import (canonical_graph, golden_dir,
                                            load_vectors)

    torch.backends.cuda.matmul.allow_tf32 = False   # float oracle in f32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    A, W, C = FxpFormat(8, 4), FxpFormat(8, 6), FxpFormat(16, 8)

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    log(f"phase 1 build: {len(libs)} kernels from src/repro_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in sorted(libs.items()):
        for line in open(f"{path}.log").read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ---------------------------
    errs = {"lstm_cell_int": 0, "mac_int": 0}
    for B, S, din, hid in ((1, 6, 1, 20), (7, 6, 3, 16), (64, 4, 2, 8),
                           (200, 6, 1, 20)):
        spec = CellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=A,
                        state_fmt=C, w_fmt=W, sig_lo=A.lo, tanh_lo=A.lo)
        args = (rand_codes(rng, A, (B, S, din)),
                rand_codes(rng, W, (din + hid, 4 * hid)),
                rand_codes(rng, FxpFormat(11, 0), (4 * hid,)),
                rand_codes(rng, A, (2 ** A.total_bits,)),
                rand_codes(rng, A, (2 ** A.total_bits,)))
        errs["lstm_cell_int"] = max(errs["lstm_cell_int"], max_abs_err(
            lstm_window_int(*args, spec=spec),
            lstm_window_int_ref(*args, spec=spec)))
    for shift in (-2, 0, 2, 6):
        for rows, K, N in ((7, 20, 1), (49, 9, 3), (21, 9, 3), (7, 9, 1),
                           (7, 21, 80), (300, 33, 17)):
            out = C if shift <= 2 else A
            args = (rand_codes(rng, A, (rows, K)), rand_codes(rng, W, (K, N)),
                    rand_codes(rng, FxpFormat(11, 0), (N,)))
            errs["mac_int"] = max(errs["mac_int"], max_abs_err(
                mac_int_op(*args, shift=shift, lo=out.lo, hi=out.hi),
                mac_int_ref(*args, shift=shift, lo=out.lo, hi=out.hi)))
    log("phase 2a kernels = plain versions at the test shapes (exact)")

    lstm_g, _, _ = canonical_graph("elastic-lstm")
    conv_g, _, _ = canonical_graph("elastic-conv1d")
    lstm_em = RTLEmulator(lstm_g, mode="fused")
    conv_em = RTLEmulator(conv_g, mode="fused")
    cell, head = lstm_g.node("lstm_cell_l0"), lstm_g.node("linear_head")
    p_cell = lstm_em.prepared(cell.name)
    cell_args = (rand_codes(rng, A, (B_SERVE, cell.seq_len, cell.d_in)),
                 p_cell["w"], p_cell["b"],
                 lstm_em.prepared(cell.sigmoid_lut)["table"],
                 lstm_em.prepared(cell.tanh_lut)["table"])
    seq = lstm_window_int(*cell_args, spec=p_cell["spec"])
    errs["lstm_cell_int"] = max(errs["lstm_cell_int"], max_abs_err(
        seq, lstm_window_int_ref(*cell_args, spec=p_cell["spec"])))
    # every MAC call shape of the main path at the serving batch
    p_head = lstm_em.prepared(head.name)
    mac_cases = {
        "lstm_head": ((seq[:, -1].contiguous(), p_head["w"], p_head["b"]),
                      requant_shift(head.in_fmt, head.w_fmt, head.out_fmt),
                      head.out_fmt),
        "lstm_gate_per_step": ((torch.cat(
            [cell_args[0][:, 0], rand_codes(rng, A, (B_SERVE, cell.hidden))],
            dim=-1), p_cell["w"], p_cell["b"]), cell.mac_shift, A),
    }
    for name in ("conv1d_0", "conv1d_1", "linear_head"):
        n = conv_g.node(name)
        p = conv_em.prepared(name)
        if n.op == "conv1d":
            x = rand_codes(rng, A, (B_SERVE, n.seq_len, n.channels))
            xh = conv1d_frames(x, n.kernel, n.stride).reshape(
                B_SERVE * n.out_len, n.kernel * n.channels).contiguous()
            args = (xh, p["w_mat"], p["b"])
        else:
            args = (rand_codes(rng, A, (B_SERVE, n.weight.shape[0])),
                    p["w"], p["b"])
        mac_cases[f"conv_{name}"] = (
            args, requant_shift(n.in_fmt, n.w_fmt, n.out_fmt), n.out_fmt)
    for name, (args, shift, fmt) in mac_cases.items():
        errs["mac_int"] = max(errs["mac_int"], max_abs_err(
            mac_int_op(*args, shift=shift, lo=fmt.lo, hi=fmt.hi),
            mac_int_ref(*args, shift=shift, lo=fmt.lo, hi=fmt.hi)))
    log(f"phase 2b kernels = plain versions at the serving shapes, "
        f"B={B_SERVE} windows (exact): {sorted(mac_cases)}")

    # ---- 3. golden replay --------------------------------------------------
    for arch, graph in (("elastic-lstm", lstm_g), ("elastic-conv1d", conv_g)):
        vs = load_vectors(golden_dir(GOLDEN, arch))
        for mode in RTLEmulator.MODES:
            got = RTLEmulator(graph, mode=mode).run_int(vs.stimulus).outputs
            if not np.array_equal(got.cpu().numpy(), vs.response):
                raise AssertionError(f"golden replay {arch} {mode} differs")
    log("phase 3 golden sets replay exactly: elastic-lstm, elastic-conv1d x "
        f"{', '.join(RTLEmulator.MODES)}")

    # ---- 4. serve ragged requests (the main path) --------------------------
    def requests(graph, sizes):
        fmt = graph.edges["x"].fmt
        return [(rng.integers(fmt.lo, fmt.hi + 1,
                              (s, *graph.edges["x"].shape)) / fmt.scale)
                .astype(np.float32) for s in sizes]

    served = {"elastic-lstm": (lstm_g, lstm_em, requests(lstm_g,
                                                         LSTM_REQUESTS)),
              "elastic-conv1d": (conv_g, conv_em, requests(conv_g,
                                                           CONV_REQUESTS))}
    path_launches = {}
    for arch, (graph, em, reqs) in served.items():
        # one dispatch: B1 once per lstm_cell, B2 once per linear/conv1d
        expected = {"lstm_cell_int": sum(n.op == "lstm_cell"
                                         for n in graph.nodes),
                    "mac_int": sum(n.op in ("linear", "conv1d")
                                   for n in graph.nodes)}
        lstm_ops.launches = 0
        mac_ops.launches = 0
        answers = em.run_many(reqs)
        torch.cuda.synchronize()
        launches = {"lstm_cell_int": lstm_ops.launches,
                    "mac_int": mac_ops.launches}
        if launches != expected:
            raise AssertionError(f"{arch}: kernel launches {launches}, "
                                 f"expected {expected}")
        path_launches[arch] = launches
        log(f"phase 4 {arch} launches: {json.dumps(launches)}")
        plain = RTLEmulator(graph, mode="jnp").run_many(reqs)
        out_shape = graph.edges[graph.outputs[0]].shape
        for req, ans, ref in zip(reqs, answers, plain):
            y = ans.outputs
            if tuple(y.shape) != (len(req), *out_shape) or \
                    not torch.isfinite(ans.outputs_f).all():
                raise AssertionError(f"{arch}: bad answer shape/values")
            if not torch.equal(y, em.run(req).outputs):
                raise AssertionError(f"{arch}: batched != solo run")
            if not torch.equal(y, ref.outputs):
                raise AssertionError(f"{arch}: fused != plain path")
        for mode in RTLEmulator.MODES:
            assert_bit_exact(graph, reqs[4], mode)       # vs float oracle
        log(f"phase 4 served {arch}: {len(reqs)} requests, "
            f"{sum(map(len, reqs))} windows; = solo runs, plain path and "
            "float oracle")
    # the kernels line reports the main path's own run: elastic-lstm
    launches = path_launches["elastic-lstm"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

    # ---- 5. timing ---------------------------------------------------------
    spec = p_cell["spec"]
    out = torch.empty_like(seq)
    kernel_rows = []
    B, S, din, H = B_SERVE, spec.seq_len, spec.d_in, spec.hidden
    depth = cell_args[3].numel() + cell_args[4].numel()
    ms = time_ms(functools.partial(lstm_window_int_cuda, *cell_args, out,
                                   spec=spec))
    plain = time_ms(functools.partial(lstm_window_int_ref, *cell_args,
                                      spec=spec), reps=3)
    bnd, by = bound_ms(4 * (B * S * din + (din + H) * 4 * H + 4 * H + depth
                            + B * S * H), B * S * (din + H) * 4 * H)
    kernel_rows.append({
        "name": "lstm_cell_int", "route": "cuda",
        "source": "src/repro_torch/csrc/lstm_cell_int.cu",
        "replaces": "src/repro/kernels/lstm_cell_int/kernel.py:52",
        "launches": launches["lstm_cell_int"],
        "max_abs_err": errs["lstm_cell_int"], "ms": ms, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": None})
    log(f"phase 5 lstm_cell_int B={B} S={S} d_in={din} H={H}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
    mac_rows = {}
    for name, (args, shift, fmt) in mac_cases.items():
        xh, w, b = args
        o = torch.empty((xh.shape[0], w.shape[1]), dtype=torch.int32,
                        device="cuda")
        k_ms = time_ms(functools.partial(mac_int_cuda, xh, w, b, o,
                                         shift=shift, lo=fmt.lo, hi=fmt.hi))
        p_ms = time_ms(functools.partial(mac_int_ref, xh, w, b, shift=shift,
                                         lo=fmt.lo, hi=fmt.hi), reps=5)
        rows, K = xh.shape
        N = w.shape[1]
        bnd, by = bound_ms(4 * (rows * K + K * N + N + rows * N),
                           rows * K * N)
        mac_rows[name] = (k_ms, p_ms, bnd, by)
        log(f"phase 5 mac_int {name} ({rows},{K})@({K},{N}) shift {shift}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bnd:.5f} ms "
            f"({by})")
    k_ms, p_ms, bnd, by = mac_rows["lstm_head"]
    kernel_rows.append({
        "name": "mac_int", "route": "cuda",
        "source": "src/repro_torch/csrc/mac_int.cu",
        "replaces": "src/repro/rtl/oplib.py:56",
        "launches": launches["mac_int"], "max_abs_err": errs["mac_int"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None})
    for arch, (graph, _, _) in served.items():
        x = requests(graph, (B_SERVE,))[0]
        run_ms = {}
        for mode in ("fused", "jnp"):
            em = RTLEmulator(graph, mode=mode)
            em.run(x)
            torch.cuda.synchronize()
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                em.run(x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
            run_ms[mode] = dt * 1e3
            log(f"phase 5 emulator {arch} {mode}: {B_SERVE / dt:.0f} "
                f"windows/s ({dt * 1e3:.3f} ms per {B_SERVE}-window run, "
                "host clock, float windows in)")
        wall, device = profile_ms(functools.partial(
            RTLEmulator(graph, mode="fused").run, x))
        busy = sum(device.values())
        if busy == 0:
            log(f"phase 5 profile {arch} fused: device time not measured "
                "(the profiler saw no GPU activity)")
            continue
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 5 profile {arch} fused, one {B_SERVE}-window run: "
            f"device busy {busy:.4f} ms = {100 * busy / run_ms['fused']:.1f}% "
            f"of the unprofiled run ({wall:.3f} ms with the profiler on); "
            + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top))

    # ---- 6. report ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)                     # the card's name and power limit
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
