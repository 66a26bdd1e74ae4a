"""Static IR verifier — abstract interpretation over the dataflow IR (port
of ``repro/rtl/analyze.py``).

The dynamic half of the toolchain (bit-exact emulation, golden vectors,
conformance fuzzing) only finds an overflowing accumulator or a mismatched
wire *after* lowering and running a design. This pass proves the same
properties statically, in milliseconds, by propagating integer value
intervals edge-by-edge through the graph (DESIGN.md §13):

* every edge gets a sound over-approximating interval ``[lo, hi]`` of the
  int codes the emulator can ever place on it (all three execution modes);
* each registered :class:`~repro_torch.rtl.oplib.HWTemplate` owns its
  transfer function (``HWTemplate.transfer``) the same way it owns
  emit/emulate/cost;
* violations are emitted as stable-rule-ID :class:`Diagnostic` records
  (``EAI001`` accumulator overflow, ``EAI002`` requant shift, ``EAI003``
  Q-format continuity, ``EAI004`` LUT domain, ``EAI005``/``EAI007``
  resource feasibility, ``EAI006`` output saturation) in a
  JSON-round-trippable :class:`AnalysisReport`, byte for byte the
  reference's.

Soundness is the contract: for every edge, every value the emulator
observes must lie inside the statically derived interval. The analysis is
a single forward pass — every recurrent state in the IR (the LSTM h/c) is
requant-*clipped* to its format each step, so its format range is already
a post-fixpoint. Bounds are exact Python integers throughout (weights read
as numpy object arrays, ROM tables as int64), so no bound can wrap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.energy.hw import HWSpec, XC7S15
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl.diagnostics import (AnalysisReport, Diagnostic,
                                   make_diagnostic)
from repro_torch.rtl.ir import ActLUTNode, Graph, Node
from repro_torch.rtl.resources import estimate

#: int32 hardware word — what the DSP accumulators and every edge hold
INT32_LO = -(2 ** 31)
INT32_HI = 2 ** 31 - 1

#: utilization above this fraction of a device budget raises EAI007
PRESSURE_THRESHOLD = 0.9


class AnalysisError(ValueError):
    """Raised by the ``analyze="error"`` gate when a design fails static
    analysis; carries the full :class:`AnalysisReport` as ``.report``."""

    def __init__(self, report: AnalysisReport) -> None:
        self.report = report
        super().__init__(report.format())


@dataclass(frozen=True)
class Interval:
    """A closed integer interval ``[lo, hi]`` — the abstract value one edge
    (or internal accumulator) can take. Arithmetic is exact python-int
    interval arithmetic: no wraparound, so overflow is *detected* by
    comparing against the int32 word, never silently reproduced."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @staticmethod
    def full(fmt: FxpFormat) -> "Interval":
        """Every representable code of ``fmt`` — the input-edge seed."""
        return Interval(fmt.lo, fmt.hi)

    @staticmethod
    def point(v: int) -> "Interval":
        return Interval(v, v)

    def add(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def mul(self, other: "Interval") -> "Interval":
        ps = (self.lo * other.lo, self.lo * other.hi,
              self.hi * other.lo, self.hi * other.hi)
        return Interval(min(ps), max(ps))

    def lshift(self, s: int) -> "Interval":
        if s < 0:
            raise ValueError(f"lshift needs s >= 0, got {s}")
        return Interval(self.lo << s, self.hi << s)

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def clip(self, fmt: FxpFormat) -> "Interval":
        """Saturation to ``fmt``: the abstract counterpart of ``torch.clamp``
        (never empty — the rails themselves are representable)."""
        return Interval(min(max(self.lo, fmt.lo), fmt.hi),
                        min(max(self.hi, fmt.lo), fmt.hi))

    def covers(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def contains(self, v: int) -> bool:
        return self.lo <= v <= self.hi

    @property
    def magnitude(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    def fits_int32(self) -> bool:
        return INT32_LO <= self.lo and self.hi <= INT32_HI

    def __str__(self) -> str:
        return f"[{self.lo}, {self.hi}]"


def requant_interval(iv: Interval, shift: int) -> Interval:
    """Sound bound of ``fxp_requant_int``'s shift *before* saturation.

    For a narrowing shift ``s > 0`` the round-half-even quotient is
    ``(v >> s) + inc`` with ``inc`` in {0, 1}, so the image lies in
    ``[lo >> s, (hi >> s) + 1]`` (python ``>>`` floors, matching the
    arithmetic shift). A widening shift is an exact left shift.
    """
    if shift > 0:
        return Interval(iv.lo >> shift, (iv.hi >> shift) + 1)
    if shift < 0:
        return iv.lshift(-shift)
    return iv


class AnalysisContext:
    """The diagnostic sink handed to ``HWTemplate.transfer``.

    ``diag`` appends a rule-table diagnostic; ``saturation`` records the
    *pre-clip* interval a template computed for an edge, so
    ``analyze_graph`` can decide wordlength sufficiency (EAI006) on the
    design's output edges without every template knowing what is an
    output. Tables of the
    graph's LUT nodes are cached per run (``lut_table``).
    """

    def __init__(self, graph: Graph) -> None:
        self.graph = graph
        self.diagnostics: List[Diagnostic] = []
        self.pre_clip: Dict[str, Interval] = {}
        self._tables: Dict[str, np.ndarray] = {}

    def diag(self, rule: str, node: str, message: str,
             edge: Optional[str] = None) -> None:
        self.diagnostics.append(make_diagnostic(rule, node, message, edge))

    def saturation(self, edge: str, pre: Interval) -> None:
        known = self.pre_clip.get(edge)
        self.pre_clip[edge] = pre if known is None else known.join(pre)

    def lut_table(self, lut: ActLUTNode) -> np.ndarray:
        t = self._tables.get(lut.name)
        if t is None:
            t = np.asarray(lut.table(), np.int64)
            self._tables[lut.name] = t
        return t


# --------------------------------------------------------------------------- #
# Shared transfer-function helpers (the math every weighted template reuses)
# --------------------------------------------------------------------------- #


def mac_interval(w_int: np.ndarray, b_int: np.ndarray,
                 row_intervals: List[Tuple[slice, Interval]]) -> Interval:
    """Interval of ``sum_i w[i, j] * x_i + b_j`` over all output columns j,
    with per-row-group input intervals (the LSTM stacks x rows over h rows).

    Uses the *actual* integer weight/bias arrays — per column, each row
    contributes ``min/max(w * x.lo, w * x.hi)`` — computed in python-int
    (object dtype) so the bound itself can never wrap.
    """
    w = np.asarray(w_int, dtype=object)
    if w.ndim != 2:
        raise ValueError(f"mac_interval needs a 2-D weight, got {w.shape}")
    b = np.asarray(b_int, dtype=object).reshape(-1)
    lo_cols = np.zeros(w.shape[1], dtype=object)
    hi_cols = np.zeros(w.shape[1], dtype=object)
    for rows, iv in row_intervals:
        blk = w[rows]
        if blk.size == 0:
            continue
        a, b2 = blk * iv.lo, blk * iv.hi
        lo_cols = lo_cols + np.minimum(a, b2).sum(axis=0)
        hi_cols = hi_cols + np.maximum(a, b2).sum(axis=0)
    lo_cols, hi_cols = lo_cols + b, hi_cols + b
    return Interval(int(lo_cols.min()) if lo_cols.size else 0,
                    int(hi_cols.max()) if hi_cols.size else 0)


def checked_requant(ctx: AnalysisContext, node: Node, acc: Interval,
                    shift: int, out_fmt: FxpFormat, edge: Optional[str], *,
                    what: str) -> Interval:
    """EAI001/EAI002 checks + the sound post-requant interval for one
    accumulator feeding ``edge``. Records the pre-clip interval for
    ``analyze_graph``'s EAI006 wordlength pass (``edge=None`` marks an
    internal accumulator: checked, but never a saturation candidate)."""
    if not acc.fits_int32():
        ctx.diag("EAI001", node.name,
                 f"{what} interval {acc} exceeds the int32 accumulator "
                 f"(|max| = {acc.magnitude} >= 2**31)", edge=edge)
        acc = acc.clip(FxpFormat(32, 0))    # keep propagating, soundly wide
    if abs(shift) > 31:
        ctx.diag("EAI002", node.name,
                 f"requant shift {shift} for {what} is outside the int32 "
                 "shifter range [-31, 31]", edge=edge)
        shift = max(-31, min(31, shift))
    pre = requant_interval(acc, shift)
    if shift < 0 and not pre.fits_int32():
        ctx.diag("EAI002", node.name,
                 f"widening requant shift {shift} for {what} overflows "
                 f"int32: {acc} << {-shift} = {pre}", edge=edge)
        pre = pre.clip(FxpFormat(32, 0))
    if edge is not None:
        ctx.saturation(edge, pre)
    return pre.clip(out_fmt)


def lut_interval(ctx: AnalysisContext, lut: ActLUTNode,
                 iv: Interval) -> Interval:
    """Output interval of a ROM lookup whose input codes lie in ``iv``:
    min/max of the *actual* table restricted to the reachable addresses
    (lookups clamp, so the full-table range is the sound fallback when the
    input interval escapes the address range)."""
    table = ctx.lut_table(lut)
    dom = Interval.full(lut.in_fmt)
    lo = max(iv.lo, dom.lo)
    hi = min(iv.hi, dom.hi)
    if lo > hi:                       # disjoint: lookups clamp to a rail
        sub = table
    else:
        sub = table[lo - lut.lo: hi - lut.lo + 1]
    return Interval(int(sub.min()), int(sub.max()))


def check_lut_domain(ctx: AnalysisContext, node: Node, lut: ActLUTNode,
                     iv: Interval, edge: Optional[str], *,
                     what: str) -> None:
    """EAI004: the pre-activation interval must lie inside the LUT's
    address range ``[in_fmt.lo, in_fmt.hi]``."""
    dom = Interval.full(lut.in_fmt)
    if not dom.covers(iv):
        ctx.diag("EAI004", node.name,
                 f"{what} interval {iv} is not covered by LUT "
                 f"{lut.name!r} address range {dom} ({lut.in_fmt})",
                 edge=edge)


def resolve_lut(graph: Graph, node: Node, name: str) -> ActLUTNode:
    """A node's LUT reference, mirroring the registry error convention:
    unknown names raise listing the act_lut nodes that ARE in the graph."""
    luts = graph.act_luts()
    try:
        return luts[name]
    except KeyError:
        raise ValueError(
            f"node {node.name!r} references act_lut {name!r} which is not "
            f"in graph {graph.name!r}; act_lut nodes present: "
            f"{sorted(luts)}") from None


# --------------------------------------------------------------------------- #
# The analysis pass
# --------------------------------------------------------------------------- #


def _structural_error(graph: Graph, msg: str) -> ValueError:
    return ValueError(
        f"graph {graph.name!r} is malformed: {msg}; declared edges: "
        f"{sorted(graph.edges)}")


def analyze_graph(graph: Graph, *, hw: HWSpec = XC7S15,
                  clock_hz: Optional[float] = None) -> AnalysisReport:
    """Run the full static analysis over ``graph``; returns the report.

    Malformed graphs (unknown node kinds, undeclared or undriven edges)
    *raise* — listing what is registered/declared, mirroring the registry
    convention — because they are toolchain bugs, not design findings.
    Design findings (overflow, format skew, LUT domain, resources) come
    back as diagnostics.
    """
    from repro_torch.rtl.oplib import get_template

    for name in graph.inputs:
        if name not in graph.edges:
            raise _structural_error(graph,
                                    f"input edge {name!r} is undeclared")
    for name in graph.outputs:
        if name not in graph.edges:
            raise _structural_error(graph,
                                    f"output edge {name!r} is undeclared")

    ctx = AnalysisContext(graph)
    intervals: Dict[str, Interval] = {
        e: Interval.full(graph.edges[e].fmt) for e in graph.inputs}
    producer: Dict[str, str] = {}

    for n in graph.nodes:
        tmpl = get_template(n.op)       # unknown kind raises, listing
        for ename, want in sorted(tmpl.wire_contract(n, graph).items()):
            if ename not in graph.edges:
                raise _structural_error(
                    graph, f"node {n.name!r} is wired to undeclared edge "
                           f"{ename!r}")
            have = graph.edges[ename].fmt
            if have != want:
                ctx.diag("EAI003", n.name,
                         f"edge {ename!r} carries {have} but the "
                         f"{n.op!r} port expects {want}", edge=ename)
        missing = [e for e in n.inputs if e not in graph.edges]
        if missing:
            raise _structural_error(
                graph, f"node {n.name!r} reads undeclared edge(s) "
                       f"{missing}")
        undriven = [e for e in n.inputs if e not in intervals]
        if undriven:
            raise _structural_error(
                graph, f"node {n.name!r} reads edge(s) {undriven} driven "
                       "by no earlier node (driven so far: "
                       f"{sorted(intervals)})")
        undeclared_out = [e for e in n.outputs if e not in graph.edges]
        if undeclared_out:
            raise _structural_error(
                graph, f"node {n.name!r} drives undeclared edge(s) "
                       f"{undeclared_out}")
        in_iv = {e: intervals[e] for e in n.inputs}
        out_iv = tmpl.transfer(n, in_iv, graph=graph, ctx=ctx)
        for ename, iv in out_iv.items():
            intervals[ename] = iv
            producer[ename] = n.name

    # EAI006 — wordlength sufficiency at the design's readout edges: the
    # pre-saturation interval must fit the declared format, or rail inputs
    # will clip at the output (legal, bit-exact — but almost never meant).
    for ename in graph.outputs:
        pre = ctx.pre_clip.get(ename)
        fmt = graph.edges[ename].fmt
        if pre is not None and not Interval.full(fmt).covers(pre):
            ctx.diag("EAI006", producer.get(ename, graph.name),
                     f"output edge {ename!r} ({fmt}) saturates: worst-case "
                     f"pre-clip interval {pre} exceeds [{fmt.lo}, {fmt.hi}]",
                     edge=ename)

    # EAI005 / EAI007 — static resource & cycle feasibility vs the HWSpec.
    rr = estimate(graph, clock_hz=clock_hz or hw.clock_hz or 100e6)
    util = rr.utilization()
    demand = {"dsp": rr.dsp, "bram36": rr.bram36, "lut": rr.lut}
    for res in sorted(util):
        u = util[res]
        budget = int(round(demand[res] / u)) if u else 0
        if u > 1.0:
            ctx.diag("EAI005", graph.name,
                     f"{res} demand {demand[res]} exceeds the {hw.name} "
                     f"budget {budget} ({u:.0%})")
        elif u > PRESSURE_THRESHOLD:
            ctx.diag("EAI007", graph.name,
                     f"{res} demand {demand[res]} uses {u:.0%} of the "
                     f"{hw.name} budget {budget}")

    resources = {"dsp": rr.dsp, "bram36": rr.bram36, "lut": rr.lut,
                 "cycles": rr.cycles, "latency_s": rr.latency_s,
                 "fits": rr.fits(),
                 **{f"util_{k}": round(v, 4) for k, v in util.items()}}
    return AnalysisReport(
        design=graph.name, hw=hw.name, diagnostics=ctx.diagnostics,
        intervals={k: (iv.lo, iv.hi) for k, iv in intervals.items()},
        resources=resources)


def worst_case_mac_bound(fan_in: int, w_fmt: FxpFormat,
                         in_fmt: FxpFormat, b_magnitude: int = 0) -> int:
    """The format-only (weight-free) accumulator bound
    ``fan_in * max|w_int| * max|x_int| + |b_int|`` — what the analysis
    falls back to when a third-party template carries no weight arrays."""
    w_mag = max(abs(w_fmt.lo), w_fmt.hi)
    x_mag = max(abs(in_fmt.lo), in_fmt.hi)
    return fan_in * w_mag * x_mag + abs(b_magnitude)


__all__ = [
    "AnalysisContext", "AnalysisError", "Interval", "analyze_graph",
    "check_lut_domain", "checked_requant", "lut_interval", "mac_interval",
    "requant_interval", "resolve_lut", "worst_case_mac_bound",
]
