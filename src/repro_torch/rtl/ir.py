"""Fixed-point dataflow IR — stage one of the RTL backend (port of
``repro/rtl/ir.py``).

The ElasticAI-Creator lowers a trained, quantized model into a small graph of
hardware-template instances before emitting VHDL. This module is that
lowering: a :class:`Graph` of node kinds, one per registered hardware
template (:mod:`repro_torch.rtl.oplib`):

    linear     — y = requant(x·W + b)            (BRAM weights, serial MACs)
    lstm_cell  — the paper's gate-fused LSTM template over one window
    conv1d     — depthwise/strided 1-D convolution (BRAM tap weights)
    act_lut    — ROM lookup for hard_sigmoid / hard_tanh
    elementwise— mul/add of two same-shape operands + requant

whose *edges* carry :class:`~repro_torch.quant.fixedpoint.FxpFormat`
annotations, so every wire in the design has an exact Q-format. The integer
semantics of each node are defined once (DESIGN.md §4) and implemented
twice: the float ``fxp_quantize`` reference and the int32 emulator in
:mod:`repro_torch.rtl.emulator` must agree integer-for-integer. Both
implementations live on the node's :class:`~repro_torch.rtl.oplib.HWTemplate`
(DESIGN.md §9) — this module only owns the node/edge datatypes and the
model-level lowering entry points.

The IR stays host-side numpy, like the reference: node weights are
``np.ndarray``, and the class names, field order and field types are the
reference's, so :func:`iso_key` gives the same digest string for the same
design in both packages.

``lower_model`` dispatches on ``cfg.family`` through the template registry
(``lstm`` → the gate-fused cell stack, ``conv1d`` → the TCN-style depthwise
stack); ``lower_linear_stack`` / ``lower_conv_stack`` lower plain parameter
stacks directly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import ModelConfig
from repro_torch.quant.fixedpoint import FxpFormat, fxp_to_int

# f32 mantissa budget: the float reference is exact only while every
# intermediate integer-scaled value stays below 2**24 (DESIGN.md §4).
_F32_EXACT_BITS = 24

ACT_KINDS = ("hard_sigmoid", "hard_tanh")


@dataclass(frozen=True)
class Edge:
    """A typed wire: shape is per-sample (no batch dim), fmt its Q-format."""

    name: str
    shape: Tuple[int, ...]
    fmt: FxpFormat

    @property
    def bits(self) -> int:
        if any(d < 0 for d in self.shape):
            raise ValueError(f"edge {self.name!r} has negative dim(s) in "
                             f"shape {self.shape}")
        # math.prod: exact ints, and () / zero-element shapes stay degenerate
        # (1 resp. 0) instead of float-promoting through np.prod
        return math.prod(self.shape) * self.fmt.total_bits


@dataclass
class Node:
    name: str
    op: str              # a registered template kind (oplib.list_templates())
    inputs: List[str]
    outputs: List[str]

    def macs(self) -> int:
        return 0


def _require_array(node: Node, name: str, value, ndim: int) -> np.ndarray:
    """Array fields are mandatory at construction: a half-built node must
    fail here with a clear message, not deep inside emission/emulation."""
    if value is None:
        raise TypeError(
            f"{type(node).__name__} {node.name!r}: field {name!r} is "
            "required (got None) — pass the trained array when "
            "constructing the node")
    arr = np.asarray(value, np.float32)
    if arr.ndim != ndim:
        raise ValueError(
            f"{type(node).__name__} {node.name!r}: {name} must be "
            f"{ndim}-D, got shape {arr.shape}")
    return arr


@dataclass
class LinearNode(Node):
    """y = requant(x @ W + b): accum at scale a.frac+w.frac -> out_fmt.

    The input is flattened per sample before the MAC loop (a serial-MAC
    template reads its operand BRAM linearly), so an upstream node may
    legally produce a multi-axis edge — e.g. the (T, C) output of a conv1d
    stack feeding a dense head.
    """

    weight: np.ndarray               # (in, out) f32 — required
    bias: np.ndarray                 # (out,) f32 — required
    w_fmt: FxpFormat = FxpFormat(8, 6)
    in_fmt: FxpFormat = FxpFormat(8, 4)
    out_fmt: FxpFormat = FxpFormat(16, 8)

    def __post_init__(self):
        self.weight = _require_array(self, "weight", self.weight, 2)
        self.bias = _require_array(self, "bias", self.bias, 1)
        if self.bias.shape[0] != self.weight.shape[1]:
            raise ValueError(
                f"LinearNode {self.name!r}: bias shape {self.bias.shape} "
                "does not match weight out-features "
                f"{self.weight.shape[1]}")

    def macs(self) -> int:
        return int(self.weight.shape[0] * self.weight.shape[1])

    def weight_int(self) -> np.ndarray:
        return fxp_to_int(self.weight, self.w_fmt).numpy()

    def bias_int(self) -> np.ndarray:
        """Bias at the accumulator scale (wide two's-complement word)."""
        bfmt = FxpFormat(32, self.in_fmt.frac_bits + self.w_fmt.frac_bits)
        return fxp_to_int(self.bias, bfmt).numpy()


@dataclass
class LSTMCellNode(Node):
    """The gate-fused LSTM template over a full window (DESIGN.md §4).

    Weights are the fused (d_in+hidden, 4*hidden) gate matrix, gate order
    i, f, g, o. Activations (x, h) share ``act_fmt``; the cell state c is
    held at ``state_fmt``. Gate pre-activations are requantized to
    ``act_fmt`` before the sigmoid/tanh LUTs — narrow LUT inputs keep the
    ROMs at 2**act_bits words, the standard RTL trick.
    """

    weight: np.ndarray               # (d_in + hidden, 4*hidden) — required
    bias: np.ndarray                 # (4*hidden,) — required
    w_fmt: FxpFormat = FxpFormat(8, 6)
    act_fmt: FxpFormat = FxpFormat(8, 4)
    state_fmt: FxpFormat = FxpFormat(16, 8)
    seq_len: int = 6
    d_in: int = 1
    hidden: int = 20
    sigmoid_lut: str = ""            # name of the ActLUTNode serving σ
    tanh_lut: str = ""

    def __post_init__(self):
        self.weight = _require_array(self, "weight", self.weight, 2)
        self.bias = _require_array(self, "bias", self.bias, 1)
        want = (self.d_in + self.hidden, 4 * self.hidden)
        if tuple(self.weight.shape) != want:
            raise ValueError(
                f"LSTMCellNode {self.name!r}: weight shape "
                f"{tuple(self.weight.shape)} != {want} "
                f"(d_in={self.d_in}, hidden={self.hidden})")
        if self.bias.shape[0] != 4 * self.hidden:
            raise ValueError(
                f"LSTMCellNode {self.name!r}: bias shape "
                f"{self.bias.shape} != ({4 * self.hidden},)")

    def macs(self) -> int:
        per_step = (self.d_in + self.hidden) * 4 * self.hidden
        elementwise = 4 * self.hidden      # f*c, i*g, o*tanh(c), + state add
        return self.seq_len * (per_step + elementwise)

    def weight_int(self) -> np.ndarray:
        return fxp_to_int(self.weight, self.w_fmt).numpy()

    def bias_int(self) -> np.ndarray:
        bfmt = FxpFormat(32, self.act_fmt.frac_bits + self.w_fmt.frac_bits)
        return fxp_to_int(self.bias, bfmt).numpy()

    @property
    def mac_shift(self) -> int:
        """Right-shift taking the gate accumulator (scale A.f+W.f) to A."""
        return self.w_fmt.frac_bits

    @property
    def state_align_shift(self) -> int:
        """Left-shift aligning σi·tg (scale 2·A.f) to σf·c (A.f+C.f)."""
        return self.state_fmt.frac_bits - self.act_fmt.frac_bits


@dataclass
class Conv1dNode(Node):
    """Depthwise, strided 1-D convolution over a (seq, channels) window.

    The TCN-style sensor template (the paper's pervasive-computing setting):
    each channel carries its own ``kernel``-tap filter held in BRAM, the tap
    MACs time-multiplex the same serial DSP schedule as the linear template,
    and the accumulator is requantized exactly like a linear node —

        y[t, c] = requant( sum_k x[t*stride + k, c] · w[k, c] + b[c] )

    with the bias at the accumulator scale (in.frac + w.frac). Output length
    is ``(seq_len - kernel) // stride + 1``; fan-in per output is ``kernel``,
    which is what the §4 envelope check must cover.
    """

    weight: np.ndarray               # (kernel, channels) f32 — required
    bias: np.ndarray                 # (channels,) f32 — required
    kernel: int = 3
    stride: int = 1
    seq_len: int = 16
    channels: int = 1
    w_fmt: FxpFormat = FxpFormat(8, 6)
    in_fmt: FxpFormat = FxpFormat(8, 4)
    out_fmt: FxpFormat = FxpFormat(8, 4)

    def __post_init__(self):
        self.weight = _require_array(self, "weight", self.weight, 2)
        self.bias = _require_array(self, "bias", self.bias, 1)
        want = (self.kernel, self.channels)
        if tuple(self.weight.shape) != want:
            raise ValueError(
                f"Conv1dNode {self.name!r}: weight shape "
                f"{tuple(self.weight.shape)} != {want} "
                f"(kernel={self.kernel}, channels={self.channels})")
        if self.bias.shape[0] != self.channels:
            raise ValueError(
                f"Conv1dNode {self.name!r}: bias shape {self.bias.shape} "
                f"!= ({self.channels},)")
        if self.stride < 1 or self.kernel < 1:
            raise ValueError(
                f"Conv1dNode {self.name!r}: kernel/stride must be >= 1")
        if self.out_len < 1:
            raise ValueError(
                f"Conv1dNode {self.name!r}: window seq_len={self.seq_len} "
                f"too short for kernel={self.kernel} (out_len < 1)")

    @property
    def out_len(self) -> int:
        return (self.seq_len - self.kernel) // self.stride + 1

    def macs(self) -> int:
        return self.out_len * self.kernel * self.channels

    def weight_int(self) -> np.ndarray:
        return fxp_to_int(self.weight, self.w_fmt).numpy()

    def bias_int(self) -> np.ndarray:
        bfmt = FxpFormat(32, self.in_fmt.frac_bits + self.w_fmt.frac_bits)
        return fxp_to_int(self.bias, bfmt).numpy()


@dataclass
class ActLUTNode(Node):
    """ROM: out_int[i] = fxp_to_int(act(i / 2**in_frac), out_fmt).

    The table is generated from the float reference itself, so LUT lookup is
    bit-exact against ``fxp_quantize(act(x))`` *by construction* for every
    representable input code.
    """

    kind: str = "hard_sigmoid"
    in_fmt: FxpFormat = FxpFormat(8, 4)
    out_fmt: FxpFormat = FxpFormat(8, 4)

    def table(self) -> np.ndarray:
        """Indexed by (code - lo), i.e. offset-binary address order."""
        from repro_torch.quant.qat import hard_sigmoid, hard_tanh

        codes = np.arange(self.in_fmt.lo, self.in_fmt.hi + 1, dtype=np.int32)
        x = torch.from_numpy(codes.astype(np.float32) / self.in_fmt.scale)
        fn = hard_sigmoid if self.kind == "hard_sigmoid" else hard_tanh
        return fxp_to_int(fn(x), self.out_fmt).numpy().astype(np.int32)

    @property
    def depth(self) -> int:
        return 2 ** self.in_fmt.total_bits

    @property
    def lo(self) -> int:
        """Address offset: table is indexed by ``code - lo``."""
        return self.in_fmt.lo


@dataclass
class ActApplyNode(Node):
    """Applies a shared :class:`ActLUTNode`'s table to its input edge."""

    lut: str = ""


@dataclass
class ElementwiseNode(Node):
    """out = requant(a (mul|add) b); operand scales are aligned in-int."""

    kind: str = "mul"                # "mul" | "add"
    a_fmt: FxpFormat = FxpFormat(8, 4)
    b_fmt: FxpFormat = FxpFormat(8, 4)
    out_fmt: FxpFormat = FxpFormat(8, 4)

    def macs(self) -> int:
        return 1


@dataclass
class Graph:
    """Nodes in execution order; edges keyed by name."""

    name: str
    nodes: List[Node] = field(default_factory=list)
    edges: Dict[str, Edge] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def act_luts(self) -> Dict[str, "ActLUTNode"]:
        """The shared ROM nodes, by name — the tables an executor preloads."""
        return {n.name: n for n in self.nodes if n.op == "act_lut"}

    def total_macs(self) -> int:
        return sum(n.macs() for n in self.nodes)

    def iso_key(self) -> str:
        """Program-isomorphism digest (see module-level :func:`iso_key`)."""
        return iso_key(self)

    def add(self, node: Node, *edges: Edge) -> Node:
        self.nodes.append(node)
        for e in edges:
            self.edges[e.name] = e
        return node


def iso_key(graph: Graph) -> str:
    """Program-isomorphism key: a stable digest of everything the executed
    program depends on *except* the values inside the weight/bias arrays.

    Two graphs share a key iff they run the identical program: same
    topology (node names, kinds, wiring), same edge shapes and Q-formats,
    and same template scalars — sequence lengths, kernel/stride, LUT
    kinds/depths/offsets, and every ``FxpFormat`` (formats determine the
    requant *shifts*; see DESIGN.md §15). Array-valued fields contribute
    only their shape: perturbing trained weights never changes the key.

    The digest is order-sensitive over ``graph.nodes`` — execution order
    is part of the program — and includes node names because the
    parameters are keyed by them. The string equals the reference
    package's for the same design.
    """
    import hashlib
    from dataclasses import fields as dc_fields

    parts: List = []
    for n in graph.nodes:
        rec: List = [type(n).__name__, n.name, n.op,
                     tuple(n.inputs), tuple(n.outputs)]
        for f in dc_fields(n):
            if f.name in ("name", "op", "inputs", "outputs"):
                continue
            v = getattr(n, f.name)
            if isinstance(v, np.ndarray):
                rec.append((f.name, "array", tuple(v.shape)))
            elif isinstance(v, FxpFormat):
                rec.append((f.name, "fmt", v.total_bits, v.frac_bits))
            else:                        # ints, strs (LUT refs, kinds), ...
                rec.append((f.name, v))
        parts.append(tuple(rec))
    for name in sorted(graph.edges):
        e = graph.edges[name]
        parts.append((name, tuple(e.shape),
                      e.fmt.total_bits, e.fmt.frac_bits))
    parts.append(("io", tuple(graph.inputs), tuple(graph.outputs)))
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def validate_formats(*, act: FxpFormat, weight: FxpFormat, state: FxpFormat,
                     fan_in: int) -> None:
    """Reject formats outside the exactness envelope (DESIGN.md §4).

    Two independent ceilings collapse to the same check: the int32 emulator
    must not overflow, and the f32 float reference must stay exact. Both hold
    while accumulated magnitudes stay below 2**24.
    """
    mac_bits = (act.total_bits - 1) + (weight.total_bits - 1) \
        + math.ceil(math.log2(max(fan_in, 1) + 1))
    ew_bits = (act.total_bits - 1) + (state.total_bits - 1) + 1
    worst = max(mac_bits, ew_bits)
    if worst > _F32_EXACT_BITS:
        raise ValueError(
            f"format combo act={act} weight={weight} state={state} "
            f"fan_in={fan_in} needs {worst} accumulator bits > "
            f"{_F32_EXACT_BITS}-bit exactness envelope")
    if state.frac_bits < act.frac_bits:
        raise ValueError(
            f"state fmt {state} must carry at least the activation "
            f"precision {act} (cell-state alignment is a left shift)")


def _kind_fmt(overrides: Optional[Mapping[str, FxpFormat]], kind: str,
              default: FxpFormat) -> FxpFormat:
    """Per-template-kind weight-format override (``w_fmt_overrides``)."""
    if not overrides:
        return default
    return overrides.get(kind, default)


def _widest(*fmts: FxpFormat) -> FxpFormat:
    """Envelope input: the widest of the weight formats actually lowered
    (an override for a kind absent from this model must not widen it)."""
    return max(fmts, key=lambda f: f.total_bits)


# --------------------------------------------------------------------------- #
# Lowering entry points
# --------------------------------------------------------------------------- #


def lower_model(cfg: ModelConfig, params, *,
                w_fmt: FxpFormat = FxpFormat(8, 6),
                act_fmt: FxpFormat = FxpFormat(8, 4),
                state_fmt: FxpFormat = FxpFormat(16, 8),
                w_fmt_overrides: Optional[Mapping[str, FxpFormat]] = None
                ) -> Graph:
    """Lower a quantized ModelConfig + trained params into the dataflow IR.

    Dispatches on ``cfg.family`` through the hardware-template registry: the
    template that declares the family (``lstm`` → ``lstm_cell``, ``conv1d`` →
    ``conv1d``) owns the model-level lowering. Unknown families raise listing
    the families that ARE lowerable, mirroring the registry errors.
    """
    from repro_torch.rtl.oplib import lowering_for

    return lowering_for(cfg.family)(
        cfg, params, w_fmt=w_fmt, act_fmt=act_fmt, state_fmt=state_fmt,
        w_fmt_overrides=w_fmt_overrides)


def lower_lstm_model(cfg: ModelConfig, params, *,
                     w_fmt: FxpFormat = FxpFormat(8, 6),
                     act_fmt: FxpFormat = FxpFormat(8, 4),
                     state_fmt: FxpFormat = FxpFormat(16, 8),
                     w_fmt_overrides: Optional[Mapping[str, FxpFormat]] = None
                     ) -> Graph:
    """The paper's ``elastic-lstm`` family: stacked gate-fused cells + head."""
    if cfg.family != "lstm":
        raise NotImplementedError(
            f"lower_lstm_model lowers family='lstm', got {cfg.family!r}")
    c = cfg.lstm
    cell_w = _kind_fmt(w_fmt_overrides, "lstm_cell", w_fmt)
    head_w = _kind_fmt(w_fmt_overrides, "linear", w_fmt)
    validate_formats(act=act_fmt, weight=_widest(cell_w, head_w),
                     state=state_fmt, fan_in=c.in_features + c.hidden)
    g = Graph(name=cfg.name)
    g.edges["x"] = Edge("x", (c.seq_len, c.in_features), act_fmt)
    g.inputs = ["x"]

    sig = ActLUTNode(name="hard_sigmoid_lut", op="act_lut", inputs=[],
                     outputs=[], kind="hard_sigmoid", in_fmt=act_fmt,
                     out_fmt=act_fmt)
    tanh = ActLUTNode(name="hard_tanh_lut", op="act_lut", inputs=[],
                      outputs=[], kind="hard_tanh", in_fmt=act_fmt,
                      out_fmt=act_fmt)
    g.nodes += [sig, tanh]

    prev = "x"
    for li, cell in enumerate(params["cells"]):
        d_in = c.in_features if li == 0 else c.hidden
        out_edge = Edge(f"h{li}", (c.hidden,), act_fmt)
        node = LSTMCellNode(
            name=f"lstm_cell_l{li}", op="lstm_cell", inputs=[prev],
            outputs=[out_edge.name],
            weight=np.asarray(cell["w"], np.float32),
            bias=np.asarray(cell["b"], np.float32),
            w_fmt=cell_w, act_fmt=act_fmt, state_fmt=state_fmt,
            seq_len=c.seq_len, d_in=d_in, hidden=c.hidden,
            sigmoid_lut=sig.name, tanh_lut=tanh.name)
        g.add(node, out_edge)
        prev = out_edge.name

    y_edge = Edge("y", (c.out_features,), state_fmt)
    g.add(LinearNode(name="linear_head", op="linear", inputs=[prev],
                     outputs=[y_edge.name],
                     weight=np.asarray(params["head_w"], np.float32),
                     bias=np.asarray(params["head_b"], np.float32),
                     w_fmt=head_w, in_fmt=act_fmt, out_fmt=state_fmt),
          y_edge)
    g.outputs = [y_edge.name]
    return g


def lower_linear_stack(name: str,
                       layers: Sequence[Tuple[np.ndarray, np.ndarray]],
                       *, w_fmt: FxpFormat = FxpFormat(8, 6),
                       act_fmt: FxpFormat = FxpFormat(8, 4),
                       accum_fmt: FxpFormat = FxpFormat(16, 8),
                       act: Optional[str] = "hard_sigmoid") -> Graph:
    """Lower a plain MLP — [(W, b), ...] with ``act`` between layers."""
    if act is not None and act not in ACT_KINDS:
        raise ValueError(f"act must be one of {ACT_KINDS} or None")
    fan_in = max(int(w.shape[0]) for w, _ in layers)
    validate_formats(act=act_fmt, weight=w_fmt, state=accum_fmt,
                     fan_in=fan_in)
    g = Graph(name=name)
    g.edges["x"] = Edge("x", (int(layers[0][0].shape[0]),), act_fmt)
    g.inputs = ["x"]
    lut = None
    if act is not None and len(layers) > 1:
        lut = ActLUTNode(name=f"{act}_lut", op="act_lut", inputs=[],
                         outputs=[], kind=act, in_fmt=act_fmt,
                         out_fmt=act_fmt)
        g.nodes.append(lut)
    prev = "x"
    for i, (w, b) in enumerate(layers):
        last = i == len(layers) - 1
        out_fmt = accum_fmt if last else act_fmt
        edge = Edge(f"a{i}" if not last else "y", (int(w.shape[1]),), out_fmt)
        g.add(LinearNode(name=f"linear_{i}", op="linear", inputs=[prev],
                         outputs=[edge.name],
                         weight=np.asarray(w, np.float32),
                         bias=np.asarray(b, np.float32),
                         w_fmt=w_fmt, in_fmt=act_fmt, out_fmt=out_fmt),
              edge)
        prev = edge.name
        if not last and lut is not None:
            edge2 = Edge(f"z{i}", (int(w.shape[1]),), act_fmt)
            g.add(ActApplyNode(name=f"{act}_{i}", op="act_apply",
                               inputs=[prev], outputs=[edge2.name],
                               lut=lut.name), edge2)
            prev = edge2.name
    g.outputs = [prev]
    return g


def lower_conv_stack(name: str,
                     blocks: Sequence[Tuple[np.ndarray, np.ndarray]],
                     head: Tuple[np.ndarray, np.ndarray],
                     *, seq_len: int,
                     stride: int = 1,
                     w_fmt: FxpFormat = FxpFormat(8, 6),
                     act_fmt: FxpFormat = FxpFormat(8, 4),
                     state_fmt: FxpFormat = FxpFormat(16, 8),
                     act: str = "hard_tanh",
                     w_fmt_overrides: Optional[Mapping[str, FxpFormat]] = None
                     ) -> Graph:
    """Lower a TCN-style depthwise conv stack + dense head.

    ``blocks`` is ``[(w (K, C), b (C,)), ...]`` applied with ``stride`` and
    ``act`` between blocks; ``head`` is the dense readout ``(W (T·C, out),
    b (out,))`` applied to the flattened final feature map. All conv
    activations stay at ``act_fmt`` (conv → LUT → conv chains keep the ROMs
    shared); the head accumulates into ``state_fmt`` like every other
    readout.
    """
    if act not in ACT_KINDS:
        raise ValueError(f"act must be one of {ACT_KINDS}")
    if not blocks:
        raise ValueError("lower_conv_stack needs at least one conv block")
    channels = int(np.asarray(blocks[0][0]).shape[1])
    conv_w = _kind_fmt(w_fmt_overrides, "conv1d", w_fmt)
    head_w_fmt = _kind_fmt(w_fmt_overrides, "linear", w_fmt)
    # envelope fan-in: every block accumulates its own kernel's tap count
    max_kernel = max(int(np.asarray(w).shape[0]) for w, _ in blocks)
    head_fan_in = int(np.asarray(head[0]).shape[0])
    validate_formats(act=act_fmt, weight=_widest(conv_w, head_w_fmt),
                     state=state_fmt, fan_in=max(max_kernel, head_fan_in))

    g = Graph(name=name)
    g.edges["x"] = Edge("x", (seq_len, channels), act_fmt)
    g.inputs = ["x"]
    lut = ActLUTNode(name=f"{act}_lut", op="act_lut", inputs=[], outputs=[],
                     kind=act, in_fmt=act_fmt, out_fmt=act_fmt)
    g.nodes.append(lut)

    prev, t = "x", seq_len
    for i, (w, b) in enumerate(blocks):
        node = Conv1dNode(
            name=f"conv1d_{i}", op="conv1d", inputs=[prev],
            outputs=[f"c{i}"],
            weight=np.asarray(w, np.float32), bias=np.asarray(b, np.float32),
            kernel=int(np.asarray(w).shape[0]), stride=stride, seq_len=t,
            channels=channels, w_fmt=conv_w, in_fmt=act_fmt,
            out_fmt=act_fmt)
        t = node.out_len
        g.add(node, Edge(f"c{i}", (t, channels), act_fmt))
        g.add(ActApplyNode(name=f"{act}_{i}", op="act_apply",
                           inputs=[f"c{i}"], outputs=[f"z{i}"],
                           lut=lut.name),
              Edge(f"z{i}", (t, channels), act_fmt))
        prev = f"z{i}"

    hw, hb = head
    if head_fan_in != t * channels:
        raise ValueError(
            f"head weight expects {head_fan_in} inputs but the conv stack "
            f"produces {t}x{channels}={t * channels} features")
    y_edge = Edge("y", (int(np.asarray(hw).shape[1]),), state_fmt)
    g.add(LinearNode(name="linear_head", op="linear", inputs=[prev],
                     outputs=[y_edge.name],
                     weight=np.asarray(hw, np.float32),
                     bias=np.asarray(hb, np.float32),
                     w_fmt=head_w_fmt, in_fmt=act_fmt, out_fmt=state_fmt),
          y_edge)
    g.outputs = [y_edge.name]
    return g


def lower_conv_model(cfg: ModelConfig, params, *,
                     w_fmt: FxpFormat = FxpFormat(8, 6),
                     act_fmt: FxpFormat = FxpFormat(8, 4),
                     state_fmt: FxpFormat = FxpFormat(16, 8),
                     w_fmt_overrides: Optional[Mapping[str, FxpFormat]] = None
                     ) -> Graph:
    """The ``conv1d`` family (TCN-style sensor workload) → conv stack IR."""
    if cfg.family != "conv1d":
        raise NotImplementedError(
            f"lower_conv_model lowers family='conv1d', got {cfg.family!r}")
    c = cfg.conv1d
    return lower_conv_stack(
        cfg.name,
        [(blk["w"], blk["b"]) for blk in params["blocks"]],
        (params["head_w"], params["head_b"]),
        seq_len=c.seq_len, stride=c.stride, w_fmt=w_fmt, act_fmt=act_fmt,
        state_fmt=state_fmt, act=c.act, w_fmt_overrides=w_fmt_overrides)
