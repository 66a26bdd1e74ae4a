"""Pluggable hardware-template (op) library — one registry entry per layer
kind (port of ``repro/rtl/oplib.py``, DESIGN.md §9).

Each :class:`HWTemplate` owns, for its IR node kind, the model-level
lowering hook (for templates that anchor a model family), the bit-exact
int32 semantics (``prepare``/``execute``) and the ``fxp_quantize`` float
oracle (``reference``). ``RTLEmulator`` and ``reference_apply`` are
registry-dispatched walks: supporting a new layer means registering one
template here. Emission, cost and static analysis come with the toolchain
slice.

Execution modes keep the reference's names so conformance reports line up:

* ``fused``  — the fused LSTM-window kernel (B1) for ``lstm_cell``, the MAC
  kernel (B2) for ``linear`` and ``conv1d``;
* ``pallas`` — the MAC kernel at every LSTM timestep (the per-step
  cross-check schedule);
* ``jnp``    — the plain PyTorch versions throughout.

The kernel wrappers run their plain versions only where the emulator's
tensors lie on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_steps)
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.quant.fixedpoint import (FxpFormat, fxp_quantize,
                                          fxp_requant_int)
from repro_torch.quant.qat import hard_sigmoid, hard_tanh
from repro_torch.rtl.ir import (ActApplyNode, ActLUTNode, Conv1dNode, Edge,
                                ElementwiseNode, Graph, LinearNode,
                                LSTMCellNode, Node, lower_conv_model,
                                lower_lstm_model)

# --------------------------------------------------------------------------- #
# The gate MAC (int matmul + bias + requant + saturate)
# --------------------------------------------------------------------------- #


def mac_int(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            shift: int, fmt: FxpFormat, mode: str) -> torch.Tensor:
    """The shared serial-MAC schedule: the plain version in ``jnp`` mode,
    the MAC kernel's wrapper otherwise."""
    if mode == "jnp":
        return mac_int_ref(xh, w, b, shift=shift, lo=fmt.lo, hi=fmt.hi)
    return mac_int_op(xh, w, b, shift=shift, lo=fmt.lo, hi=fmt.hi)


def requant_shift(in_fmt: FxpFormat, w_fmt: FxpFormat,
                  out_fmt: FxpFormat) -> int:
    """Right-shift taking a MAC accumulator (scale in.f + w.f) to out.f —
    the one requant convention every weighted template shares."""
    return in_fmt.frac_bits + w_fmt.frac_bits - out_fmt.frac_bits


# --------------------------------------------------------------------------- #
# Float-oracle helpers (identical semantics expressed with fxp_quantize only)
# --------------------------------------------------------------------------- #


def ref_q(x, fmt: FxpFormat) -> torch.Tensor:
    return fxp_quantize(x, fmt)


def ref_bias(b, in_fmt: FxpFormat, w_fmt: FxpFormat) -> torch.Tensor:
    return ref_q(b, FxpFormat(32, in_fmt.frac_bits + w_fmt.frac_bits))


def ref_act(lut: ActLUTNode, v: torch.Tensor) -> torch.Tensor:
    fn = hard_sigmoid if lut.kind == "hard_sigmoid" else hard_tanh
    return ref_q(fn(ref_q(v, lut.in_fmt)), lut.out_fmt)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A node's float array on the device of the walk's tensors."""
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------- #
# The template contract
# --------------------------------------------------------------------------- #


class HWTemplate:
    """One hardware template: the full vertical for one IR node kind.

    Subclasses set ``kind`` (the ``Node.op`` string they serve) and
    ``node_cls`` and implement the hooks. ``family`` is optional: a
    template that anchors a whole model family (the LSTM cell, the conv1d
    block) also provides ``lower_model_fn`` so ``ir.lower_model`` can
    dispatch on ``cfg.family``. ``sequential`` — the node takes a slot in
    the design's enable→done handshake chain (combinational LUT
    applications don't).
    """

    kind: str = ""
    node_cls: type = Node
    family: Optional[str] = None
    lower_model_fn: Optional[Callable[..., Graph]] = None
    sequential: bool = True

    def probe_graph(self, rng) -> Optional[Graph]:
        """A minimal standalone design exercising just this template, with
        ``rng``-drawn constants. ``None`` means the template has no
        standalone compute (shared ROMs)."""
        return None

    def prepare(self, node: Node, graph: Graph) -> Dict:
        """Host-side constants to hoist once at emulator construction.

        np.ndarray values become int32 tensors on the emulator's device;
        anything else (e.g. a CellSpec) is stored as-is.
        """
        return {}

    def execute(self, node: Node, env: Dict, em, mode: str) -> None:
        """Int32 semantics: read input edges from ``env``, write outputs.

        ``em`` is the executing :class:`~repro_torch.rtl.emulator.
        RTLEmulator` (``em.prepared(name)``, ``em.lookup(lut, codes)``);
        ``mode`` is one of its execution paths.
        """
        raise NotImplementedError

    def reference(self, node: Node, env: Dict,
                  luts: Dict[str, ActLUTNode]) -> None:
        """Float-oracle semantics, built only from ``fxp_quantize``."""
        raise NotImplementedError


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, HWTemplate] = {}


def register_template(template: HWTemplate, *,
                      overwrite: bool = False) -> HWTemplate:
    """Register ``template`` under ``template.kind``. Registering a kind
    twice is an error unless ``overwrite=True``."""
    kind = template.kind
    if not kind:
        raise ValueError(f"{type(template).__name__} has no kind set")
    if not overwrite and kind in _REGISTRY:
        raise ValueError(f"hardware template {kind!r} already registered "
                         f"(registered: {list_templates()})")
    _REGISTRY[kind] = template
    return template


def list_templates() -> List[str]:
    """Names of every registered template kind, sorted."""
    return sorted(_REGISTRY)


def get_template(kind: str) -> HWTemplate:
    """Resolve a node kind. Unknown kinds raise ``ValueError`` listing what
    *is* registered, so the error message doubles as discovery."""
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown hardware template {kind!r}; registered templates: "
            f"{list_templates()}") from None


def lowerable_families() -> List[str]:
    """Model families some registered template can lower end-to-end."""
    return sorted({t.family for t in _REGISTRY.values() if t.family})


def lowering_for(family: str) -> Callable[..., Graph]:
    """The model-level lowering hook for ``family`` (``ir.lower_model``)."""
    for t in _REGISTRY.values():
        if t.family == family and t.lower_model_fn is not None:
            return t.lower_model_fn
    raise NotImplementedError(
        f"no registered hardware template lowers family {family!r}; "
        f"lowerable families: {lowerable_families()} "
        "(use lower_linear_stack/lower_conv_stack for parameter stacks)")


# --------------------------------------------------------------------------- #
# Built-in templates
# --------------------------------------------------------------------------- #


class LinearTemplate(HWTemplate):
    """y = requant(flatten(x) @ W + b) — serial MACs, BRAM weights."""

    kind = "linear"
    node_cls = LinearNode

    def prepare(self, n: LinearNode, graph: Graph) -> Dict:
        return {"w": n.weight_int(), "b": n.bias_int()}

    def execute(self, n: LinearNode, env: Dict, em, mode: str) -> None:
        x = env[n.inputs[0]].to(torch.int32)
        x = x.reshape(x.shape[0], -1).contiguous()   # serial MACs read linearly
        p = em.prepared(n.name)
        shift = requant_shift(n.in_fmt, n.w_fmt, n.out_fmt)
        env[n.outputs[0]] = mac_int(x, p["w"], p["b"], shift=shift,
                                    fmt=n.out_fmt, mode=mode)

    def reference(self, n: LinearNode, env: Dict, luts: Dict) -> None:
        src = env[n.inputs[0]]
        src = src.reshape(src.shape[0], -1)
        wq = ref_q(_const(n.weight, src), n.w_fmt)
        bq = ref_bias(_const(n.bias, src), n.in_fmt, n.w_fmt)
        env[n.outputs[0]] = ref_q(src @ wq + bq, n.out_fmt)

    def probe_graph(self, rng) -> Graph:
        in_fmt, out_fmt = FxpFormat(8, 4), FxpFormat(16, 8)
        g = Graph(name="probe_linear")
        g.edges["x"] = Edge("x", (5,), in_fmt)
        g.inputs = ["x"]
        g.add(LinearNode(
            name="linear_0", op=self.kind, inputs=["x"], outputs=["y"],
            weight=(rng.standard_normal((5, 3)) * 0.5).astype(np.float32),
            bias=(rng.standard_normal(3) * 0.1).astype(np.float32),
            w_fmt=FxpFormat(8, 6), in_fmt=in_fmt, out_fmt=out_fmt),
            Edge("y", (3,), out_fmt))
        g.outputs = ["y"]
        return g


class LSTMCellTemplate(HWTemplate):
    """The paper's gate-fused LSTM window template (DESIGN.md §4)."""

    kind = "lstm_cell"
    node_cls = LSTMCellNode
    family = "lstm"
    lower_model_fn = staticmethod(lower_lstm_model)

    def prepare(self, n: LSTMCellNode, graph: Graph) -> Dict:
        luts = graph.act_luts()
        return {"w": n.weight_int(), "b": n.bias_int(),
                "spec": CellSpec(
                    seq_len=n.seq_len, d_in=n.d_in, hidden=n.hidden,
                    act_fmt=n.act_fmt, state_fmt=n.state_fmt, w_fmt=n.w_fmt,
                    sig_lo=luts[n.sigmoid_lut].lo,
                    tanh_lo=luts[n.tanh_lut].lo)}

    def execute(self, n: LSTMCellNode, env: Dict, em, mode: str) -> None:
        # a stacked cell consumes the previous cell's full sequence
        src = env.get(n.inputs[0] + ".seq", env[n.inputs[0]])
        src = src.to(torch.int32).contiguous()
        p = em.prepared(n.name)
        args = (src, p["w"], p["b"], em.prepared(n.sigmoid_lut)["table"],
                em.prepared(n.tanh_lut)["table"])
        if mode == "fused":
            seq = lstm_window_int(*args, spec=p["spec"])
        else:                            # one MAC per timestep
            seq = lstm_window_steps(
                *args, spec=p["spec"],
                mac=mac_int_ref if mode == "jnp" else mac_int_op)
        env[n.outputs[0]] = seq[:, -1]
        env[n.outputs[0] + ".seq"] = seq

    def reference(self, n: LSTMCellNode, env: Dict, luts: Dict) -> None:
        src = env.get(n.inputs[0] + ".seq", env[n.inputs[0]])
        A, C = n.act_fmt, n.state_fmt
        sig, tanh = luts[n.sigmoid_lut], luts[n.tanh_lut]
        wq = ref_q(_const(n.weight, src), n.w_fmt)
        bq = ref_bias(_const(n.bias, src), A, n.w_fmt)
        B = src.shape[0]
        h = torch.zeros((B, n.hidden), dtype=torch.float32, device=src.device)
        c = torch.zeros_like(h)
        outs = []
        for t in range(n.seq_len):
            z = ref_q(torch.cat([src[:, t], h], dim=-1) @ wq + bq, A)
            i, f, g, o = torch.split(z, n.hidden, dim=-1)
            si, sf, so = ref_act(sig, i), ref_act(sig, f), ref_act(sig, o)
            tg = ref_act(tanh, g)
            c = ref_q(sf * c + si * tg, C)
            h = ref_q(so * ref_act(tanh, ref_q(c, A)), A)
            outs.append(h)
        env[n.outputs[0]] = h
        env[n.outputs[0] + ".seq"] = torch.stack(outs, dim=1)

    def probe_graph(self, rng) -> Graph:
        d_in, hidden, seq = 1, 4, 3
        act, state = FxpFormat(8, 4), FxpFormat(16, 8)
        g = Graph(name="probe_lstm_cell")
        g.edges["x"] = Edge("x", (seq, d_in), act)
        g.inputs = ["x"]
        sig = ActLUTNode(name="hard_sigmoid_lut", op="act_lut", inputs=[],
                         outputs=[], kind="hard_sigmoid", in_fmt=act,
                         out_fmt=act)
        tanh = ActLUTNode(name="hard_tanh_lut", op="act_lut", inputs=[],
                          outputs=[], kind="hard_tanh", in_fmt=act,
                          out_fmt=act)
        g.nodes += [sig, tanh]
        g.add(LSTMCellNode(
            name="lstm_cell_0", op=self.kind, inputs=["x"], outputs=["h"],
            weight=(rng.standard_normal((d_in + hidden, 4 * hidden)) * 0.4)
            .astype(np.float32),
            bias=(rng.standard_normal(4 * hidden) * 0.1).astype(np.float32),
            act_fmt=act, state_fmt=state, seq_len=seq, d_in=d_in,
            hidden=hidden, sigmoid_lut=sig.name, tanh_lut=tanh.name),
            Edge("h", (hidden,), act))
        g.outputs = ["h"]
        return g


class Conv1dTemplate(HWTemplate):
    """Depthwise/strided 1-D convolution (TCN-style sensor workloads).

    Execution reuses the shared serial-MAC template exactly the way the
    fabric would: the (kernel, channels) taps are expanded once, at
    prepare time, into a channel-block-diagonal (kernel·channels, channels)
    matrix, and each output step is an im2col frame MAC'd through
    :func:`mac_int` — the zero entries contribute nothing, so integer
    values are identical to the per-channel tap loop.
    """

    kind = "conv1d"
    node_cls = Conv1dNode
    family = "conv1d"
    lower_model_fn = staticmethod(lower_conv_model)

    @staticmethod
    def _frames(x: torch.Tensor, n: Conv1dNode) -> torch.Tensor:
        """(B, S, C) -> (B, out_len, kernel, C) strided tap windows."""
        from repro_torch.model.conv1d import conv1d_frames

        return conv1d_frames(x, n.kernel, n.stride)

    def prepare(self, n: Conv1dNode, graph: Graph) -> Dict:
        K, C = n.kernel, n.channels
        w = np.asarray(n.weight_int(), np.int32)           # (K, C)
        w_mat = np.zeros((K * C, C), np.int32)
        for k in range(K):
            w_mat[k * C + np.arange(C), np.arange(C)] = w[k]
        return {"w_mat": w_mat, "b": np.asarray(n.bias_int(), np.int32)}

    def execute(self, n: Conv1dNode, env: Dict, em, mode: str) -> None:
        x = env[n.inputs[0]].to(torch.int32)               # (B, S, C)
        p = em.prepared(n.name)
        B, t_out = x.shape[0], n.out_len
        xh = self._frames(x, n).reshape(B * t_out, n.kernel * n.channels)
        shift = requant_shift(n.in_fmt, n.w_fmt, n.out_fmt)
        y = mac_int(xh.contiguous(), p["w_mat"], p["b"], shift=shift,
                    fmt=n.out_fmt, mode=mode)
        env[n.outputs[0]] = y.reshape(B, t_out, n.channels)

    def reference(self, n: Conv1dNode, env: Dict, luts: Dict) -> None:
        x = env[n.inputs[0]]
        wq = ref_q(_const(n.weight, x), n.w_fmt)           # (K, C)
        bq = ref_bias(_const(n.bias, x), n.in_fmt, n.w_fmt)
        frames = self._frames(x, n)                        # (B, T, K, C)
        z = torch.einsum("btkc,kc->btc", frames, wq) + bq
        env[n.outputs[0]] = ref_q(z, n.out_fmt)

    def probe_graph(self, rng) -> Graph:
        K, C, S = 3, 2, 8
        fmt = FxpFormat(8, 4)
        node = Conv1dNode(
            name="conv1d_0", op=self.kind, inputs=["x"], outputs=["y"],
            weight=(rng.standard_normal((K, C)) * 0.5).astype(np.float32),
            bias=(rng.standard_normal(C) * 0.1).astype(np.float32),
            kernel=K, stride=1, seq_len=S, channels=C,
            in_fmt=fmt, out_fmt=fmt)
        g = Graph(name="probe_conv1d")
        g.edges["x"] = Edge("x", (S, C), fmt)
        g.inputs = ["x"]
        g.add(node, Edge("y", (node.out_len, C), fmt))
        g.outputs = ["y"]
        return g


class ActLUTTemplate(HWTemplate):
    """Shared activation ROM: computes nothing alone; its table is hoisted
    once and read through ``RTLEmulator.lookup``."""

    kind = "act_lut"
    node_cls = ActLUTNode
    sequential = False

    def prepare(self, n: ActLUTNode, graph: Graph) -> Dict:
        return {"table": n.table()}

    def execute(self, n: ActLUTNode, env: Dict, em, mode: str) -> None:
        pass                                    # a ROM computes nothing alone

    def reference(self, n: ActLUTNode, env: Dict, luts: Dict) -> None:
        pass


class ActApplyTemplate(HWTemplate):
    """Wiring-only application of a shared ROM: combinational lookup."""

    kind = "act_apply"
    node_cls = ActApplyNode
    sequential = False

    def probe_graph(self, rng) -> Graph:
        """Also the act_lut vertical's probe: the shared ROM only computes
        through an application node, so they are fuzzed together."""
        fmt = FxpFormat(8, 4)
        kind = ("hard_sigmoid", "hard_tanh")[int(rng.integers(0, 2))]
        g = Graph(name="probe_act_apply")
        g.edges["x"] = Edge("x", (6,), fmt)
        g.inputs = ["x"]
        lut = ActLUTNode(name=f"{kind}_lut", op="act_lut", inputs=[],
                         outputs=[], kind=kind, in_fmt=fmt, out_fmt=fmt)
        g.nodes.append(lut)
        g.add(ActApplyNode(name="act_0", op=self.kind, inputs=["x"],
                           outputs=["y"], lut=lut.name), Edge("y", (6,), fmt))
        g.outputs = ["y"]
        return g

    def execute(self, n: ActApplyNode, env: Dict, em, mode: str) -> None:
        env[n.outputs[0]] = em.lookup(n.lut, env[n.inputs[0]])

    def reference(self, n: ActApplyNode, env: Dict, luts: Dict) -> None:
        env[n.outputs[0]] = ref_act(luts[n.lut], env[n.inputs[0]])


class ElementwiseTemplate(HWTemplate):
    """out = requant(a (mul|add) b) on one DSP slice."""

    kind = "elementwise"
    node_cls = ElementwiseNode

    def probe_graph(self, rng) -> Graph:
        fmt, out_fmt = FxpFormat(8, 4), FxpFormat(8, 5)
        ew_kind = ("mul", "add")[int(rng.integers(0, 2))]
        g = Graph(name="probe_elementwise")
        g.edges["x"] = Edge("x", (6,), fmt)
        g.inputs = ["x"]
        g.add(ElementwiseNode(name="ew_0", op=self.kind, inputs=["x", "x"],
                              outputs=["y"], kind=ew_kind, a_fmt=fmt,
                              b_fmt=fmt, out_fmt=out_fmt),
              Edge("y", (6,), out_fmt))
        g.outputs = ["y"]
        return g

    def execute(self, n, env: Dict, em, mode: str) -> None:
        a = env[n.inputs[0]].to(torch.int32)
        b = env[n.inputs[1]].to(torch.int32)
        fa, fb = n.a_fmt.frac_bits, n.b_fmt.frac_bits
        if n.kind == "mul":
            y = fxp_requant_int(a * b, fa + fb, n.out_fmt)
        else:
            hi = max(fa, fb)
            y = fxp_requant_int((a << (hi - fa)) + (b << (hi - fb)), hi,
                                n.out_fmt)
        env[n.outputs[0]] = y

    def reference(self, n, env: Dict, luts: Dict) -> None:
        a, b = env[n.inputs[0]], env[n.inputs[1]]
        v = a * b if n.kind == "mul" else a + b
        env[n.outputs[0]] = ref_q(v, n.out_fmt)


register_template(LinearTemplate())
register_template(LSTMCellTemplate())
register_template(Conv1dTemplate())
register_template(ActLUTTemplate())
register_template(ActApplyTemplate())
register_template(ElementwiseTemplate())
