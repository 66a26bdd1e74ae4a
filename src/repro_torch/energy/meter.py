"""8-channel energy meter — the Elastic Node PAC1934 analogue (port of
``repro/energy/meter.py``).

The Elastic Node's defining feature is *per-function-region* power
measurement (two PAC1934 meters → 8 channels), so developers can see where
the energy goes and optimize that region. A step's work is partitioned into
8 "function regions"; each gets a roofline-derived time and an energy
estimate from :class:`HWSpec` power numbers.

Channels (region → what the PAC1934 channel would be wired to):
  1 mxu        — matmul/convolution FLOPs (the tensor cores)
  2 vpu        — elementwise math (exp/tanh/mul/…)
  3 reduce     — reductions (softmax/norm sums)
  4 hbm        — main-memory traffic (bytes accessed)
  5 ici        — inter-chip collectives (wire bytes)
  6 gather     — embedding/cache gathers + scatters
  7 layout     — copies/transposes/concatenations (data movement)
  8 other      — control, host transfer, everything else

Two producers fill the channels' work. :func:`meter_channels` reads
compiled HLO text, as the reference does, and gives the same work and op
counts on the same text (dot FLOPs exact, elementwise and reduce channels
element-count estimates). The port's host target counts its torch program
instead (:mod:`repro_torch.energy.cost`), each aten op placed by
:func:`aten_channel`. Both turn work into seconds and joules through
:func:`channel_report`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.energy.hw import H100_SXM, HWSpec
from repro_torch.energy.roofline import (_DTYPE_BYTES, _SHAPE_RE,
                                         parse_collectives)

# HLO opcodes by channel (the reference's sets)
_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "power", "exponential", "log",
    "tanh", "logistic", "maximum", "minimum", "select", "compare", "and",
    "or", "not", "xor", "negate", "abs", "sign", "rsqrt", "sqrt", "convert",
    "clamp", "floor", "ceil", "round-nearest-afz", "exponential-minus-one",
    "cosine", "sine", "is-finite",
}
_REDUCE = {"reduce", "reduce-window"}
_GATHER = {"gather", "scatter", "dynamic-slice", "dynamic-update-slice"}
_LAYOUT = {"copy", "transpose", "reshape", "broadcast", "concatenate",
           "slice", "pad", "reverse", "iota", "bitcast", "bitcast-convert"}

# The same channels for aten ops (by overload packet name, e.g. "mm",
# "index_put_"). An op in none of these sets goes to ``vpu`` if torch tags
# it pointwise, else to ``other``.
ATEN_MXU = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
            "_int_mm", "convolution"}
ATEN_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "std_mean", "argmax", "argmin",
               "logsumexp", "norm", "linalg_vector_norm", "cumsum",
               "_softmax", "_log_softmax"}
ATEN_GATHER = {"index", "index_select", "gather", "embedding", "take",
               "index_put", "index_put_", "_index_put_impl_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "index_add",
               "index_add_", "index_copy", "index_copy_", "masked_select",
               "masked_scatter", "masked_scatter_"}
ATEN_LAYOUT = {"copy_", "clone", "cat", "stack", "constant_pad_nd",
               "repeat", "repeat_interleave", "flip", "roll", "tril",
               "triu", "zeros", "zeros_like", "ones", "ones_like", "full",
               "full_like", "new_zeros", "new_ones", "new_full", "fill_",
               "zero_", "fill", "arange"}
#: dtype conversions, XLA's ``convert``: elementwise
ATEN_CONVERT = {"_to_copy"}


def aten_channel(name: str, pointwise: bool) -> str:
    """The meter channel of an aten op named ``name`` (its overload
    packet); ``pointwise`` is whether torch tags it so."""
    if name in ATEN_MXU:
        return "mxu"
    if name in ATEN_REDUCE:
        return "reduce"
    if name in ATEN_GATHER:
        return "gather"
    if name in ATEN_LAYOUT:
        return "layout"
    if pointwise or name in ATEN_CONVERT:
        return "vpu"
    return "other"


_OP_RE = re.compile(r"=\s*((?:\()?[\w\[\],{}\s]*?(?:\))?)\s*([\w-]+)\(")
_DOT_DIMS_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")

# H100 SXM's non-tensor float32 rate (NVIDIA's data sheet: 67 TFLOP/s): the
# CUDA cores that run elementwise math and reductions
VPU_FLOPS = 67e12
GATHER_BW_FRACTION = 0.5  # gathers achieve ~half of streaming HBM bandwidth

# per-channel active power split (ASSUMPTION: a split of the H100 SXM's
# 700 W power limit, not a measurement; sums to 700)
CHANNEL_WATTS = {
    "mxu": 350.0, "vpu": 90.0, "reduce": 30.0, "hbm": 140.0,
    "ici": 40.0, "gather": 20.0, "layout": 15.0, "other": 15.0,
}


def _shape_elems(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n
    return total


@dataclass
class ChannelReport:
    """Per-channel work, time and energy for one step."""

    work: Dict[str, float] = field(default_factory=dict)     # flops or bytes
    seconds: Dict[str, float] = field(default_factory=dict)
    joules: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return max(self.seconds.values()) if self.seconds else 0.0

    @property
    def serial_seconds(self) -> float:
        return sum(self.seconds.values())

    @property
    def total_joules(self) -> float:
        return sum(self.joules.values())

    def table(self) -> str:
        rows = [f"{'channel':>8} {'work':>12} {'ms':>9} {'mJ':>9} {'ops':>6}"]
        for ch in CHANNEL_WATTS:
            rows.append(
                f"{ch:>8} {self.work.get(ch, 0):12.3e} "
                f"{self.seconds.get(ch, 0)*1e3:9.3f} "
                f"{self.joules.get(ch, 0)*1e3:9.3f} "
                f"{self.op_counts.get(ch, 0):6d}")
        return "\n".join(rows)


def channel_report(work: Dict[str, float], op_counts: Dict[str, int],
                   hw: HWSpec = H100_SXM) -> ChannelReport:
    """Seconds and joules of each channel from its work: FLOPs over the
    tensor-core peak (``mxu``) or :data:`VPU_FLOPS` (``vpu``, ``reduce``),
    bytes over the HBM rate (``hbm``, ``layout``, ``other``; ``gather`` at
    :data:`GATHER_BW_FRACTION` of it) or the link rate (``ici``); energy is
    :data:`CHANNEL_WATTS` × channel time."""
    w = {ch: work.get(ch, 0.0) for ch in CHANNEL_WATTS}
    secs = {
        "mxu": w["mxu"] / hw.peak_flops,
        "vpu": w["vpu"] / VPU_FLOPS,
        "reduce": w["reduce"] / VPU_FLOPS,
        "hbm": w["hbm"] / hw.hbm_bw,
        "ici": (w["ici"] / hw.link_bw) if hw.link_bw else 0.0,
        "gather": w["gather"] / (hw.hbm_bw * GATHER_BW_FRACTION),
        "layout": w["layout"] / hw.hbm_bw,
        "other": w["other"] / hw.hbm_bw,
    }
    joules = {ch: CHANNEL_WATTS[ch] * secs[ch] for ch in CHANNEL_WATTS}
    return ChannelReport(work=w, seconds=secs, joules=joules,
                         op_counts={ch: op_counts.get(ch, 0)
                                    for ch in CHANNEL_WATTS})


_DEF_RE = re.compile(
    r"^(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(\(?[\w\[\]\{\},\s]*?\)?)\s*[\w\-]+\(")
_OPND_RE = re.compile(r"\(\s*%([\w\.\-]+)")


def _dot_flops(line: str, out_elems: int, defs) -> float:
    """Exact dot FLOPs: 2 · output_elems · contraction size. Operand shapes
    are looked up in the definition table (compiled HLO references operands
    by name only)."""
    dims_m = _DOT_DIMS_RE.search(line)
    if not dims_m:
        return 2.0 * out_elems  # unknown: count 1 MAC/elem
    lhs_dims = None
    om = _OPND_RE.search(line.split("=", 1)[1])
    if om and om.group(1) in defs:
        shapes = _SHAPE_RE.findall(defs[om.group(1)])
        if shapes:
            lhs_dims = [int(d) for d in shapes[0][1].split(",") if d]
    if lhs_dims is None:  # fallback: operand shapes inline (unoptimized HLO)
        shapes = _SHAPE_RE.findall(line.split("(", 1)[1])
        if not shapes:
            return 2.0 * out_elems
        lhs_dims = [int(d) for d in shapes[0][1].split(",") if d]
    contract = 1
    for idx in dims_m.group(1).split(","):
        if idx and int(idx) < len(lhs_dims):
            contract *= lhs_dims[int(idx)]
    return 2.0 * out_elems * contract


def meter_channels(hlo_text: str, n_devices: int,
                   hw: HWSpec = H100_SXM) -> ChannelReport:
    """The channels of a compiled HLO module, as the reference meters them
    (equal work and op counts on the same text)."""
    w = {k: 0.0 for k in CHANNEL_WATTS}
    counts = {k: 0 for k in CHANNEL_WATTS}

    # pass 1: definition table %name -> output-shape string
    defs = {}
    for line in hlo_text.splitlines():
        dm = _DEF_RE.match(line.strip())
        if dm:
            defs[dm.group(1)] = dm.group(2)

    for line in hlo_text.splitlines():
        ls = line.strip()
        m = _OP_RE.search(ls)
        if not m or ls.startswith("ENTRY") or ls.startswith("HloModule"):
            continue
        out_shape, op = m.group(1), m.group(2)
        elems = _shape_elems(out_shape)
        byts = 0
        for d, dim in _SHAPE_RE.findall(out_shape):
            if d in _DTYPE_BYTES:
                n = 1
                for x in dim.split(","):
                    if x:
                        n *= int(x)
                byts += n * _DTYPE_BYTES[d]
        if op in ("dot", "convolution"):
            w["mxu"] += _dot_flops(ls, elems, defs)
            counts["mxu"] += 1
        elif op in _REDUCE:
            w["reduce"] += elems * 8.0      # ~input elems (est. 8× output)
            counts["reduce"] += 1
        elif op in _ELEMENTWISE or op == "fusion":
            w["vpu"] += elems
            counts["vpu"] += 1
        elif op in _GATHER:
            w["gather"] += byts * 2.0       # read + write
            counts["gather"] += 1
        elif op in _LAYOUT:
            w["layout"] += byts * 2.0
            counts["layout"] += 1
        elif any(op.startswith(k) for k in
                 ("all-", "reduce-scatter", "collective")):
            pass                             # handled via parse_collectives
        else:
            w["other"] += byts
            counts["other"] += 1

    coll = parse_collectives(hlo_text, n_devices)
    w["ici"] = coll.total_wire_bytes
    counts["ici"] = sum(coll.counts.values())
    # HBM channel: all bytes touched by compute ops (approximation: fusion
    # outputs + layout + gather traffic)
    w["hbm"] = (w["vpu"] * 2.0      # elementwise read+write, ~1B/elem avg…
                + w["layout"] + w["gather"])
    return channel_report(w, counts, hw)
