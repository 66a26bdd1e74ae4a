"""Three-term roofline model of one step (port of
``repro/energy/roofline.py``; the arithmetic is the reference's).

    compute_s    = FLOPs_per_device / peak_FLOP/s
    memory_s     = bytes_per_device / HBM_bw
    collective_s = wire_bytes_per_device / link_bw

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
collectives from the compiled HLO text; the port's host target reads both
from the counted torch program (:mod:`repro_torch.energy.cost`), whose op
list holds no collective on one card, so ``collective_s`` is 0 there.
:func:`parse_collectives` still reads HLO text (each collective's *local
operand size* turned into per-device wire bytes with the standard ring
formulas, the group size parsed from ``replica_groups``; collectives inside
``while`` bodies are flagged), so a reference artifact reads the same in
both packages. The dry-run (``launch/dryrun.py``) counts a mesh step's
collectives itself and hands :func:`roofline` its
:class:`CollectiveStats`, the same ring formulas (:func:`ring_bytes`)
giving their wire bytes. The default spec is the card the port runs on,
``H100_SXM``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.energy.hw import H100_SXM, HWSpec

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3b11fnuz": 1, "f4e2m1fn": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    """'f32[16,128]' -> bytes; tuples handled by caller via findall."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    if m:
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:  # iota format [groups, group_size]
        return int(m.group(2))
    return default


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    local_bytes: Dict[str, int] = field(default_factory=dict)   # operand bytes
    wire_bytes: Dict[str, float] = field(default_factory=dict)  # per-device
    in_while: int = 0
    ops: List[Tuple[str, int, int, float]] = field(default_factory=list)

    def add(self, kind: str, n: int, opnd: int, wire: float) -> None:
        """One collective of ``kind`` over ``n`` ranks."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.local_bytes[kind] = self.local_bytes.get(kind, 0) + opnd
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) + wire
        self.ops.append((kind, n, opnd, wire))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_local_bytes(self) -> int:
        return sum(self.local_bytes.values())


def parse_collectives(hlo_text: str, n_devices: int) -> CollectiveStats:
    """Sum collective operand sizes + ring-model wire bytes from (post-SPMD)
    compiled HLO text."""
    st = CollectiveStats()
    in_while_depth = 0
    for line in hlo_text.splitlines():
        ls = line.strip()
        # crude while-body tracking: computations are emitted as blocks whose
        # names contain "while" when XLA outlines loop bodies/conditions
        if ls.startswith("%") and "while" in ls.split("(")[0] and ls.endswith("{"):
            in_while_depth += 1
        if in_while_depth and ls == "}":
            in_while_depth -= 1
        m = re.search(r"=\s*((?:\()?[\w\[\]\{\},\s]*(?:\))?)\s*("
                      + "|".join(_COLLECTIVE_KINDS) + r")(-start|-done)?\(", ls)
        if not m:
            continue
        out_shape, kind, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":  # -start carries the shapes; don't double count
            continue
        if phase == "-start":
            # async start outputs a (operand, result) tuple: take the result
            # (the larger element) rather than summing both
            sizes = [_shape_bytes(f"{d}[{dims}]")
                     for d, dims in _SHAPE_RE.findall(out_shape)]
            out_b = max(sizes) if sizes else 0
        else:
            out_b = _shape_bytes(out_shape)
        n = _group_size(ls, n_devices)
        opnd, wire = ring_bytes(kind, out_b, n)
        st.add(kind, n, opnd, wire)
        if in_while_depth:
            st.in_while += 1
    return st


def ring_bytes(kind: str, out_b: int, n: int) -> Tuple[int, float]:
    """(operand bytes, per-device wire bytes) of one collective of
    ``kind`` whose result holds ``out_b`` bytes, over a group of ``n``,
    by the standard ring algorithms."""
    if kind == "all-reduce":
        return out_b, 2 * out_b * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return out_b // max(n, 1), out_b * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return out_b * n, out_b * (n - 1)          # input is n× the output
    if kind == "all-to-all":
        return out_b, out_b * (n - 1) / max(n, 1)
    return out_b, out_b                            # collective-permute


def normalize_cost(cost) -> Dict[str, float]:
    """A cost analysis as one dict: a list or tuple (one dict per
    partition, as older jax releases returned it) gives its first entry,
    ``None`` an empty dict."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return cost or {}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6·N·D (train) / 2·N_active·D (serve)
    useful_ratio: float           # model_flops / (flops_per_device * chips)
    step_s: float                 # max of the three terms (no-overlap bound)
    mfu: float                    # model_flops / (chips*peak*step_s)
    memory_analysis: str = ""
    collectives: Optional[CollectiveStats] = None

    def row(self) -> str:
        return (f"{self.arch:>18} {self.shape:>11} {self.mesh:>8} "
                f"{self.compute_s*1e3:9.2f} {self.memory_s*1e3:9.2f} "
                f"{self.collective_s*1e3:9.2f}  {self.bottleneck:>10} "
                f"{self.useful_ratio:6.2f} {self.mfu*100:6.1f}%")


def roofline(
    *, arch: str, shape: str, mesh: str, n_devices: int,
    cost: Dict[str, float], hlo_text: str, model_flops: float,
    hw: HWSpec = H100_SXM, memory_analysis: str = "",
    collectives: Optional[CollectiveStats] = None,
) -> RooflineReport:
    """The report of one step. ``collectives``: the step's collectives
    where they were counted (the dry-run's); else they are read from
    ``hlo_text``."""
    cost = normalize_cost(cost)
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = (collectives if collectives is not None
            else parse_collectives(hlo_text, n_devices))
    wire = coll.total_wire_bytes

    compute_s = flops / hw.peak_flops
    memory_s = byts / hw.hbm_bw
    collective_s = wire / hw.link_bw if hw.link_bw else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    total_flops = flops * n_devices
    useful = model_flops / total_flops if total_flops else 0.0
    mfu = (model_flops / (n_devices * hw.peak_flops * step_s)
           if step_s > 0 else 0.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=byts,
        wire_bytes_per_device=wire, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=bottleneck,
        model_flops=model_flops, useful_ratio=useful, step_s=step_s, mfu=mfu,
        memory_analysis=memory_analysis, collectives=coll)


HEADER = (f"{'arch':>18} {'shape':>11} {'mesh':>8} {'comp_ms':>9} "
          f"{'mem_ms':>9} {'coll_ms':>9}  {'bottleneck':>10} {'useful':>6} "
          f"{'MFU':>6}")
