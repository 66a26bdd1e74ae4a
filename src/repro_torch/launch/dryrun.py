"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): prove that every
(arch × shape × mesh) cell's step runs on the production mesh, and report
its roofline terms, without a card and without 512 processes.

The reference lowers and compiles each cell's step on 512 forced host
devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
HLO's collectives. The port runs the step of one rank, rank 0, on
``meta`` tensors, in a process whose ``torch.distributed`` group is a
fake one of 256 (16 × 16) or 512 (2 × 16 × 16) ranks (:func:`fake_world`):
each collective returns at once and moves nothing, each tensor has the
shape of rank 0's block, and nothing executes.

* FLOPs and bytes accessed: ``energy/cost.py::count_step``, one count of
  every aten op and kernel wrapper the step issues.
* Memory: :class:`MemoryStats`, the count's argument, output, alias
  and temp bytes, in place of ``memory_analysis()``, with the arguments'
  bytes by input.
* Collectives: a :class:`~repro_torch.energy.roofline.CollectiveStats` of
  every collective the step issues, by kind: their counts and operand
  bytes, and their ring-model wire bytes a rank by
  ``energy/roofline.py::ring_bytes``, ``shardmap``'s regions' and the
  ``DTensor`` redistributions' (the ``_c10d_functional`` ops) alike.
* Units: ``energy/hw.py::H100_SXM`` (its bf16 peak, HBM rate and NVLink
  rate), the card the port runs on.

The inputs are rank 0's blocks (``Stepper.abstract_inputs``' shapes):
the train step takes the parameter and ZeRO-1 moment blocks of
``Stepper.state_shardings()`` and the whole batch, which the step cuts
over the data axes; the serving steps take ``lm.model_blocks``' blocks,
the batch cut by ``lm.batch_pspecs`` and the cache by its schema's
layouts (a data rank's block of the batch is what that rank computes),
and run in a region manual over the data axes that cut the batch (so
that the MoE's region over them does not cut the rows again).
The window families' serving shapes run the plain window forward, as the
reference's do.

Modes, the reference's: ``unroll`` one count at full depth;
``extrapolate`` a full-depth count under ``scan_layers`` for the memory
figures, and the counts at the reduced depths of
:func:`extrapolation_plan`, unrolled, combined affinely for the FLOPs,
bytes and collectives (eager counts are affine in depth); ``proof`` the
full-depth ``scan_layers`` count alone.

A step that reads a tensor's values (``.item()``, a data-dependent
shape) raises on ``meta``; the MoE's capacities are static bounds, as the
reference's abstract lowering takes them.

Importing this module starts no process group: :func:`lower_cell` (and
so :func:`main`) starts a fake one in its own process where none is
running.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ALL_IDS, get_config
from repro_torch.core.target import model_flops_estimate
from repro_torch.core.types import (ParallelismConfig, shape_table_for,
                                    shapes_for)
from repro_torch.energy.cost import (COLLECTIVE_WRAPPERS, COLLECTIVES,
                                     count_step)
from repro_torch.energy.hw import H100_SXM
from repro_torch.energy.roofline import (HEADER, CollectiveStats,
                                         RooflineReport, ring_bytes,
                                         roofline)
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.model.layers import local_blocks, placements
from repro_torch.model.lm import (WINDOW_FAMILIES, Stepper, batch_pspecs,
                                  model_blocks)

MESH_NAMES = {False: "16x16", True: "2x16x16"}


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------

#: whether this module started the running process group
_started = False


def _register_fake_backend() -> None:
    """``torch.distributed``'s fake backend (``FakeProcessGroup``: every
    collective returns at once and moves nothing), registered as
    ``"fake"`` where no one has."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return

    def create(common, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is None:
            return FakeProcessGroup(common.group_rank, common.group_size)
        return make(common.group_rank, common.group_size, backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


def fake_world(world: int) -> None:
    """A process group of ``world`` ranks in this process, which is its
    rank 0, on the fake backend. A running group of at least ``world``
    ranks is kept (a mesh takes its first ranks); one this module started
    with fewer is replaced; one it did not start is left to
    ``make_production_mesh``, which raises if it is too small."""
    import torch.distributed as dist

    global _started
    if dist.is_initialized():
        if dist.get_world_size() >= world or not _started:
            return
        dist.destroy_process_group()
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    _started = True


# ---------------------------------------------------------------------------
# Counting one cell
# ---------------------------------------------------------------------------



@dataclasses.dataclass
class MemoryStats:
    """One step's memory figures a device, in place of a compiled
    module's ``memory_analysis()`` (whose field names these are): the
    count's argument, output, alias and temp bytes
    (``energy/cost.py::StepCost``), and ``arguments``, the argument bytes
    by input (``params``, ``opt_state``, ``batch``, ``cache``)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int
    arguments: Dict[str, int]

    def __str__(self) -> str:
        return ("MemoryStats("
                f"argument_size_in_bytes={self.argument_size_in_bytes}, "
                f"output_size_in_bytes={self.output_size_in_bytes}, "
                f"alias_size_in_bytes={self.alias_size_in_bytes}, "
                f"temp_size_in_bytes={self.temp_size_in_bytes})")


#: collective kind of each ``c10d`` and ``_c10d_functional`` op a step may
#: issue (a point-to-point exchange counts at its sends)
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
#: ops that move nothing of their own (a receive counts at its send)
_UNCOUNTED = {"recv_", "recv_any_source_", "barrier"} | COLLECTIVE_WRAPPERS
#: ``c10d`` ops whose operands are their second argument (the first holds
#: the results)
_OPERANDS_SECOND = {"allgather_", "_allgather_base_",
                    "allgather_into_tensor_coalesced_", "reduce_scatter_",
                    "_reduce_scatter_base_", "alltoall_", "alltoall_base_"}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a
    ``ProcessGroup`` or a functional collective's group name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            try:        # a ProcessGroup boxed by the dispatcher
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue        # another boxed object (a ReduceOp)
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a process group")


class _Collectives(TorchDispatchMode):
    """Logs every collective a step issues into :attr:`stats`, its wire
    bytes by the ring formulas (``roofline.ring_bytes``). Raises on a
    collective it does not know, so that none goes uncounted."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace not in COLLECTIVES:
            return out
        name = func.overloadpacket.__name__
        if name in _UNCOUNTED:
            return out
        if name not in _KINDS:
            raise NotImplementedError(f"the dry-run does not count the "
                                      f"collective {func}")
        kind = _KINDS[name]
        n = _group_size(list(args) + list(kwargs.values()))
        if func.namespace == "_c10d_functional":
            out_b = _tensor_bytes(out)
        else:
            opnd = _tensor_bytes(args[1] if name in _OPERANDS_SECOND
                                 else args[0])
            out_b = {"all-gather": opnd * n,
                     "reduce-scatter": _tensor_bytes(args[0])}.get(kind,
                                                                   opnd)
        opnd, wire = ring_bytes(kind, out_b, n)
        self.stats.add(kind, n, opnd, wire)
        return out


def _cell_step(st: Stepper, split: bool = True):
    """``(fn, {input name: rank 0's meta blocks})`` of one cell's step
    (see the module doc). ``split=False``: the train step of
    ``lm._mesh_grad_fn(split=False)``, every rank computing the model
    whole."""
    from repro_torch.model import lm
    from repro_torch.model.layers import Sharding, axes_of

    cfg, shape, mcfg, mesh = st.cfg, st.shape, st.mesh_cfg, st.mesh
    ab = st.abstract_inputs()
    if shape.kind == "train":
        sh = st.state_shardings()
        step = (st.train_fn(donate=True) if split else lm._mesh_train_step(
            cfg, mcfg, st.par, st.opt_cfg, mesh, True, split=False))
        return step, {"params": local_blocks(ab["params"], sh["params"]),
                      "opt_state": local_blocks(ab["opt_state"], sh["opt"]),
                      "batch": ab["batch"]}
    bspecs = batch_pspecs(cfg, shape, mcfg)
    batch = local_blocks(ab["batch"], {
        k: Sharding(mesh, placements(mesh, bspecs[k])) for k in ab["batch"]})
    if cfg.family in WINDOW_FAMILIES:
        apply_fn = lm._window_apply(cfg)

        def window(p, b):
            with torch.no_grad():
                return apply_fn(p, b["x"], cfg)[0]

        params = local_blocks(ab["params"], st.shardings(st.schema))
        return window, {"params": params, "batch": {"x": batch["x"]}}
    params = model_blocks(ab["params"], cfg, mcfg, mesh)
    ba = axes_of(bspecs["tokens"][0])
    # the rank's rows: a region manual over the axes that cut them, so
    # that no region inside (the MoE's) cuts them again
    rows = (lm.rows_region(mesh, ba, batch["tokens"].shape[0])
            if ba else contextlib.nullcontext())
    if shape.kind == "prefill":
        prefill = st.prefill_fn()

        def serve(p, b):
            with torch.no_grad(), rows:
                return prefill(p, b)

        return serve, {"params": params, "batch": batch}
    decode = st.decode_fn()

    def tick(p, tokens, cache):
        with torch.no_grad(), rows:
            return decode(p, tokens, cache)

    cache = local_blocks(ab["cache"], st.shardings(
        lm.batch_cut_cache(st.cache_schema(), bspecs["tokens"][0],
                           shape.global_batch, st.par.scan_layers)))
    return tick, {"params": params, "batch": batch["tokens"],
                  "cache": cache}


def _tree_bytes(tree) -> int:
    from repro_torch.model.layers import tree_leaves

    return sum(_tensor_bytes(t) for t in tree_leaves(tree))


def _compile_cell(cfg, shape, mcfg, mesh, par, split: bool = True):
    """One count of the cell's step of rank 0 (the reference's lower and
    compile): ``(cost dict, MemoryStats, CollectiveStats, seconds)``. The
    cost dict holds ``flops``, ``bytes accessed`` and, as ``work``, the
    count's work by meter channel."""
    st = Stepper(cfg, shape, mcfg, par, mesh=mesh)
    t0 = time.perf_counter()
    fn, args = _cell_step(st, split)
    log = _Collectives()

    def run(*a):
        with log:
            return fn(*a)

    cost = count_step(run, tuple(args.values()))
    mem = MemoryStats(cost.argument_bytes, cost.output_bytes,
                      cost.alias_bytes, cost.temp_bytes,
                      {k: _tree_bytes(v) for k, v in args.items()})
    return (dict(cost.cost_analysis(), work=dict(cost.work)), mem, log.stats,
            time.perf_counter() - t0)


def extrapolation_plan(cfg):
    """[(n_layers, weight)] s.t. cost(full) = Σ w_i · cost(L_i).

    Every layer of a homogeneous group issues the same ops, so a count is
    exactly affine in the group's layer count; two (three for the zamba2
    unit structure) reduced-depth unrolled counts recover the
    coefficients (the reference's plan, line for line). The zamba2 plan
    is exact where a unit has more than 2 layers (the config's has 6):
    its third point, ``u + 2`` layers, is then a unit and two layers.
    """
    T = cfg.n_layers
    if cfg.family in WINDOW_FAMILIES:
        return [(T, 1.0)]
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        # zamba2 unit structure: f(T) = a + n_units·c_unit + rem·b_layer.
        # Wide spacing (Δ=2 units / 2 layers), as the reference's.
        u = cfg.shared_attn_every
        n_units = T // u
        rem = T - n_units * u
        # c_unit=(f(3u)-f(u))/2, b=(f(u+2)-f(u))/2, a=f(u)-c_unit
        w_u = 1.0 - (n_units - 1) / 2.0 - rem / 2.0
        return [(u, w_u), (3 * u, (n_units - 1) / 2.0), (u + 2, rem / 2.0)]
    k = cfg.moe.first_dense if (cfg.family == "moe" and cfg.moe) else 0
    L1 = k + 1
    delta = min(6, T - L1)
    L2 = L1 + delta
    if T <= L2 or delta <= 0:
        return [(T, 1.0)]
    w2 = (T - L1) / delta
    return [(L1, 1.0 - w2), (L2, w2)]


def _combine(parts) -> Tuple[Dict[str, float], CollectiveStats]:
    """The affine combination ``Σ w · count`` of ``[(weight, cost,
    CollectiveStats)]``: FLOPs, bytes, work, and the collectives' counts
    (rounded), operand bytes and wire bytes."""
    cost: Dict[str, float] = {"flops": 0.0, "bytes accessed": 0.0}
    work: Dict[str, float] = {}
    coll = CollectiveStats()
    counts: Dict[str, float] = {}
    for w, c, st in parts:
        cost["flops"] += w * float(c.get("flops", 0.0))
        cost["bytes accessed"] += w * float(c.get("bytes accessed", 0.0))
        for k, v in c.get("work", {}).items():
            work[k] = work.get(k, 0.0) + w * v
        for k, v in st.counts.items():
            counts[k] = counts.get(k, 0.0) + w * v
        for k, v in st.local_bytes.items():
            coll.local_bytes[k] = coll.local_bytes.get(k, 0) + w * v
        for k, v in st.wire_bytes.items():
            coll.wire_bytes[k] = coll.wire_bytes.get(k, 0.0) + w * v
    coll.counts = {k: int(round(v)) for k, v in counts.items()}
    cost["work"] = work
    return cost, coll


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               par: Optional[ParallelismConfig] = None, verbose: bool = True,
               mode: str = "extrapolate", cfg_transform=None):
    """Count one cell; returns (RooflineReport, seconds).

    mode="unroll":      one count at full depth, unrolled
    mode="extrapolate": a full-depth count under scan-over-layers (the
                        memory figures, and proof that the step runs at
                        full scale) + 2-3 reduced-depth unrolled counts
                        whose affine combination gives the FLOPs, bytes
                        and collectives
    mode="proof":       the full-depth scan-over-layers count alone
    """
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = shape_table_for(cfg)[shape_name]
    mcfg = mesh_config(multi_pod=multi_pod)
    fake_world(mcfg.n_devices)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    par = par or ParallelismConfig()
    mesh_name = MESH_NAMES[multi_pod]

    def report(cost, mem, coll):
        return roofline(
            arch=arch, shape=shape_name, mesh=mesh_name,
            n_devices=mcfg.n_devices, cost=cost, hlo_text="",
            model_flops=model_flops_estimate(cfg, shape), hw=H100_SXM,
            memory_analysis=str(mem), collectives=coll)

    if mode not in ("unroll", "extrapolate", "proof"):
        raise ValueError(f"mode {mode!r}")
    if mode == "unroll" or cfg.family in WINDOW_FAMILIES:
        cost, mem, coll, rep_dt = _compile_cell(cfg, shape, mcfg, mesh, par)
        rep = report(cost, mem, coll)
    else:
        par_scan = dataclasses.replace(par, scan_layers=True)
        cost, mem, coll, rep_dt = _compile_cell(cfg, shape, mcfg, mesh,
                                                par_scan)
        if mode == "extrapolate":
            parts = []
            for L, w in extrapolation_plan(cfg):
                cost_L, _, coll_L, dt_L = _compile_cell(
                    cfg.with_(n_layers=L), shape, mcfg, mesh, par)
                parts.append((w, cost_L, coll_L))
                rep_dt += dt_L
            cost, coll = _combine(parts)
        rep = report(cost, mem, coll)

    if verbose:
        print(f"--- {arch} × {shape_name} × {mesh_name} "
              f"(count {rep_dt:.1f}s, mode={mode}) ---")
        print(f"  memory_analysis: {rep.memory_analysis}")
        print(f"  flops/device={rep.flops_per_device:.3e} "
              f"bytes/device={rep.bytes_per_device:.3e} "
              f"wire/device={rep.wire_bytes_per_device:.3e}")
        print(f"  terms: compute={rep.compute_s*1e3:.2f}ms "
              f"memory={rep.memory_s*1e3:.2f}ms "
              f"collective={rep.collective_s*1e3:.2f}ms "
              f"-> bottleneck={rep.bottleneck} MFU={rep.mfu*100:.1f}%")
        print(f"  collectives: {rep.collectives.counts} "
              f"(in_while={rep.collectives.in_while})")
    return rep, rep_dt


def report_json(rep: RooflineReport, compile_s: float) -> dict:
    """The reference's JSON of one cell (``compile_seconds``: the
    count's)."""
    d = dataclasses.asdict(rep)
    d.pop("collectives", None)
    d["collective_counts"] = rep.collectives.counts
    d["collective_local_bytes"] = rep.collectives.local_bytes
    d["collective_wire_bytes"] = rep.collectives.wire_bytes
    d["collectives_in_while"] = rep.collectives.in_while
    d["compile_seconds"] = compile_s
    return d


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) of ``--all``: each arch's ``shapes_for``."""
    return [(arch, sh) for arch in ALL_IDS
            for sh in shapes_for(get_config(arch))]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ALL_IDS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) for the chosen mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="directory for per-cell JSON")
    ap.add_argument("--mode", default="extrapolate",
                    choices=["extrapolate", "unroll", "proof"],
                    help="extrapolate: full-depth scan count + reduced-L "
                         "unrolled count extrapolation; unroll: one "
                         "full-depth unrolled count; proof: the full-depth "
                         "scan count only")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape required unless --all")
    return args


def cells_for(args: argparse.Namespace) -> List[Tuple[bool, str, str]]:
    """The (multi_pod, arch, shape) cells ``args`` ask for, in the
    reference's order."""
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    return [(mp, arch, sh) for mp in meshes for arch, sh in cells]


def main(argv=None) -> int:
    args = parse_args(argv)
    par = ParallelismConfig()
    rows, failures = [], []
    for mp, arch, sh in cells_for(args):
        try:
            rep, dt = lower_cell(arch, sh, multi_pod=mp, par=par,
                                 mode=args.mode)
            rows.append(rep)
            if args.json:
                p = pathlib.Path(args.json)
                p.mkdir(parents=True, exist_ok=True)
                (p / f"{arch}__{sh}__{MESH_NAMES[mp]}.json").write_text(
                    json.dumps(report_json(rep, dt), indent=2))
        except Exception as e:  # noqa: BLE001 — report all failures at end
            failures.append((arch, sh, mp, repr(e)))
            print(f"FAILED {arch} × {sh} (multi_pod={mp}): {e}",
                  file=sys.stderr)

    print("\n" + HEADER)
    for r in rows:
        print(r.row())
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(rows)} cells counted OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
