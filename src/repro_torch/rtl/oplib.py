"""Pluggable hardware-template (op) library — one registry entry per layer
kind, end to end (port of ``repro/rtl/oplib.py``, DESIGN.md §9).

Each :class:`HWTemplate` owns the full vertical for its IR node kind:

* **lower**   — the model-level lowering hook (templates that anchor a
  model family);
* **verify**  — the stimulus hooks the conformance harness fuzzes with
  (``input_spec``, ``sample_inputs``) and the declared error budget;
* **analyze** — the wire contract and the interval transfer function of
  the static verifier (:mod:`repro_torch.rtl.analyze`);
* **emulate** — the bit-exact int32 semantics (``prepare``/``execute``)
  and the ``fxp_quantize`` float oracle (``reference``);
* **emit**    — the VHDL-like entity, ``.mem`` init files and top-netlist
  instance line;
* **cost**    — the XC7S15 resource/cycle formula (DESIGN.md §5).

``emit.emit_graph``, ``analyze.analyze_graph``, ``RTLEmulator``/
``reference_apply`` and ``resources.node_cost`` are registry-dispatched
walks: supporting a new layer means registering one template here.

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

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                               lstm_window_steps)
from repro_torch.kernels.mac_int import mac_int_op, mac_int_ref
from repro_torch.quant.fixedpoint import (FxpFormat, fxp_quantize,
                                          fxp_requant_int)
from repro_torch.quant.qat import hard_sigmoid, hard_tanh
from repro_torch.rtl import templates as T
from repro_torch.rtl.analyze import (AnalysisContext, Interval,
                                     check_lut_domain, checked_requant,
                                     lut_interval, mac_interval,
                                     requant_interval, resolve_lut)
from repro_torch.rtl.ir import (ActApplyNode, ActLUTNode, Conv1dNode, Edge,
                                ElementwiseNode, Graph, LinearNode,
                                LSTMCellNode, Node, lower_conv_model,
                                lower_lstm_model)
from repro_torch.rtl.resources import (CONV_DSP, LINEAR_DSP, LSTM_DSP,
                                       LUT_ROM_BITS, PIPE, NodeCost,
                                       brams_for)

# --------------------------------------------------------------------------- #
# The gate MAC (int matmul + bias + requant + saturate)
# --------------------------------------------------------------------------- #


def mac_int(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            shift: int, fmt: FxpFormat, mode: str,
            interpret: Optional[bool] = None) -> torch.Tensor:
    """The shared serial-MAC schedule: the plain version in ``jnp`` mode,
    the MAC kernel's wrapper otherwise. ``interpret`` (the reference's
    Pallas flag, ``em.interpret`` in a template) is accepted and not read:
    the tensors' device picks the kernel or its plain version. The
    operands may have any layout, as a JAX array has none (a template's
    ``x.reshape`` of a sliced edge is a strided view): the kernel gets
    contiguous copies where they are not."""
    if mode == "jnp":
        return mac_int_ref(xh, w, b, shift=shift, lo=fmt.lo, hi=fmt.hi)
    return mac_int_op(xh.contiguous(), w.contiguous(), b.contiguous(),
                      shift=shift, lo=fmt.lo, hi=fmt.hi)


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
    dispatch on ``cfg.family``.

    Netlist flags: ``in_netlist`` — the node appears in the top-level
    netlist (shared ROM entities don't; they are instantiated where used);
    ``sequential`` — it takes a slot in the enable→done handshake chain
    (combinational LUT applications don't).
    """

    kind: str = ""
    node_cls: type = Node
    family: Optional[str] = None
    lower_model_fn: Optional[Callable[..., Graph]] = None
    in_netlist: bool = True
    sequential: bool = True
    #: the node carries a quantized weight array
    has_weights: bool = False
    #: top-netlist port names for the default single-in/single-out instance
    port_in: str = "x"
    port_out: str = "y"

    # ---- verify -----------------------------------------------------------
    def input_spec(self, node: Node, graph: Graph):
        """(per-sample shape, FxpFormat) of the edge driving this node —
        what a stimulus generator must produce. Default: the first input."""
        e = graph.edges[node.inputs[0]]
        return e.shape, e.fmt

    def sample_inputs(self, node: Node, graph: Graph, rng, *,
                      batch: int = 8) -> np.ndarray:
        """Deterministic float stimulus for conformance fuzzing
        (``repro_torch.verify``): the three corner rows (all-zero /
        rail-low / rail-high codes) followed by seeded uniform codes over
        the representable range, dequantized — so ``fxp_to_int`` recovers
        exactly the drawn codes. ``rng`` is a numpy Generator, so both
        packages draw the same codes from one seed.
        """
        from repro_torch.verify.vectors import corner_codes

        shape, fmt = self.input_spec(node, graph)
        corners = corner_codes(shape, fmt)[:batch]
        n_rand = batch - corners.shape[0]
        codes = corners
        if n_rand > 0:
            rand = rng.integers(fmt.lo, fmt.hi + 1, size=(n_rand, *shape),
                                dtype=np.int64).astype(np.int32)
            codes = np.concatenate([corners, rand], axis=0)
        return codes.astype(np.float32) / fmt.scale

    def probe_graph(self, rng) -> Optional[Graph]:
        """A minimal standalone design exercising just this template, with
        ``rng``-drawn constants — the unit the conformance harness fuzzes
        per registered kind. ``None`` means the template has no standalone
        compute (shared ROMs) and is covered through the kinds that use
        it."""
        return None

    def error_budget_lsb(self, node: Node) -> int:
        """Allowed |int − float-oracle| at this node's output, in output
        LSBs (DESIGN.md §10). The built-in templates return 0: inside the
        §4 exactness envelope int32 arithmetic and the f32 oracle agree
        integer for integer, so any nonzero difference is a bug. A
        third-party template whose schedule reorders accumulation beyond
        the envelope declares its slack here."""
        return 0

    # ---- analyze (DESIGN.md §13) ------------------------------------------
    def wire_contract(self, node: Node,
                      graph: Graph) -> Dict[str, FxpFormat]:
        """Edge name -> the Q-format this template's ports assume on that
        wire; the static verifier reports EAI003 where the declared
        ``Edge.fmt`` differs. Default: nothing to check."""
        return {}

    def transfer(self, node: Node, in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        """Abstract-interpretation hook: map input-edge intervals to
        output-edge intervals (integer codes), emitting diagnostics
        through ``ctx``. The default — every output takes the full range of
        its edge's format — is sound for any template that saturates its
        outputs to the edge format."""
        return {e: Interval.full(graph.edges[e].fmt)
                for e in node.outputs}

    def prepare(self, node: Node, graph: Graph) -> Dict:
        """Host-side constants to hoist once at emulator construction.

        np.ndarray values become int32 tensors on the emulator's device;
        anything else (e.g. a CellSpec) is stored as-is.
        """
        return {}

    def execute(self, node: Node, env: Dict, em, mode: str) -> None:
        """Int32 semantics: read input edges from ``env``, write outputs.

        ``em`` is the executing :class:`~repro_torch.rtl.emulator.
        RTLEmulator` (``em.prepared(name)``, ``em.lookup(lut, codes)``,
        ``em.interpret``); ``mode`` is one of its execution paths.
        """
        raise NotImplementedError

    def reference(self, node: Node, env: Dict,
                  luts: Dict[str, ActLUTNode]) -> None:
        """Float-oracle semantics, built only from ``fxp_quantize``."""
        raise NotImplementedError

    # ---- emit -------------------------------------------------------------
    def emit(self, graph: Graph, node: Node, out: Dict[str, str]) -> None:
        """Render the entity text + ``.mem`` init files into ``out``."""
        raise NotImplementedError

    def instance(self, graph: Graph, node: Node, *, enable: str,
                 done: str) -> str:
        """The top-netlist instantiation line for this node."""
        return T.INSTANCE.substitute(
            label=f"i_{node.name}", entity=node.name, enable=enable,
            port_in=self.port_in, wire_in=node.inputs[0],
            port_out=self.port_out, wire_out=node.outputs[0], done=done)

    # ---- cost -------------------------------------------------------------
    def cost(self, node: Node) -> NodeCost:
        return NodeCost.zero(node.name, node.op)


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


def unregister_template(kind: str) -> None:
    """Remove a registered kind (primarily for tests swapping templates)."""
    _REGISTRY.pop(kind, None)


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
    has_weights = True

    def wire_contract(self, n: LinearNode,
                      graph: Graph) -> Dict[str, FxpFormat]:
        return {n.inputs[0]: n.in_fmt, n.outputs[0]: n.out_fmt}

    def transfer(self, n: LinearNode, in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        acc = mac_interval(n.weight_int(), n.bias_int(),
                           [(slice(None), in_intervals[n.inputs[0]])])
        out = checked_requant(
            ctx, n, acc, requant_shift(n.in_fmt, n.w_fmt, n.out_fmt),
            n.out_fmt, n.outputs[0], what="x@W+b accumulator")
        return {n.outputs[0]: out}

    def prepare(self, n: LinearNode, graph: Graph) -> Dict:
        return {"w": n.weight_int(), "b": n.bias_int()}

    def execute(self, n: LinearNode, env: Dict, em, mode: str) -> None:
        x = env[n.inputs[0]].to(torch.int32)
        x = x.reshape(x.shape[0], -1).contiguous()   # serial MACs read linearly
        p = em.prepared(n.name)
        shift = requant_shift(n.in_fmt, n.w_fmt, n.out_fmt)
        env[n.outputs[0]] = mac_int(x, p["w"], p["b"], shift=shift,
                                    fmt=n.out_fmt, mode=mode,
                                    interpret=em.interpret)

    def reference(self, n: LinearNode, env: Dict, luts: Dict) -> None:
        src = env[n.inputs[0]]
        src = src.reshape(src.shape[0], -1)
        wq = ref_q(_const(n.weight, src), n.w_fmt)
        bq = ref_bias(_const(n.bias, src), n.in_fmt, n.w_fmt)
        env[n.outputs[0]] = ref_q(src @ wq + bq, n.out_fmt)

    def emit(self, graph: Graph, n: LinearNode, out: Dict[str, str]) -> None:
        w_mem, b_mem = f"{n.name}_w.mem", f"{n.name}_b.mem"
        out[w_mem] = T.to_hex_lines(n.weight_int(), n.w_fmt.total_bits)
        out[b_mem] = T.to_hex_lines(n.bias_int(), 32)
        out[f"{n.name}.vhd"] = T.LINEAR.substitute(
            header=T.header(graph.name, n.name), name=n.name,
            in_features=n.weight.shape[0], out_features=n.weight.shape[1],
            x_generic=T.fmt_generic("X", n.in_fmt),
            w_generic=T.fmt_generic("W", n.w_fmt),
            y_generic=T.fmt_generic("Y", n.out_fmt),
            x_width=n.weight.shape[0] * n.in_fmt.total_bits,
            y_width=n.weight.shape[1] * n.out_fmt.total_bits,
            macs=n.macs(), n_dsp=LINEAR_DSP, w_mem=w_mem, b_mem=b_mem,
            rom_depth=int(n.weight.size), w_bits=n.w_fmt.total_bits,
            requant_shift=requant_shift(n.in_fmt, n.w_fmt,
                                        n.out_fmt))

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

    def cost(self, n: LinearNode) -> NodeCost:
        macs = n.macs()
        mac_cycles = math.ceil(macs / LINEAR_DSP)
        out = n.weight.shape[1]
        w_bits = n.weight.size * n.w_fmt.total_bits
        b_bits = n.bias.size * 32
        return NodeCost(
            n.name, n.op,
            cycles=mac_cycles + out + PIPE,
            active_cycles=mac_cycles + out,
            dsp=LINEAR_DSP, bram36=brams_for(w_bits + b_bits),
            lut=60 + 8 * n.out_fmt.total_bits)


class LSTMCellTemplate(HWTemplate):
    """The paper's gate-fused LSTM window template (DESIGN.md §4)."""

    kind = "lstm_cell"
    node_cls = LSTMCellNode
    has_weights = True
    family = "lstm"
    lower_model_fn = staticmethod(lower_lstm_model)
    port_out = "h_out"

    def wire_contract(self, n: LSTMCellNode,
                      graph: Graph) -> Dict[str, FxpFormat]:
        return {n.inputs[0]: n.act_fmt, n.outputs[0]: n.act_fmt}

    def transfer(self, n: LSTMCellNode, in_intervals: Dict[str, Interval],
                 *, graph: Graph,
                 ctx: AnalysisContext) -> Dict[str, Interval]:
        """Single forward pass, no fixpoint needed: h and c are requant-
        clipped to act/state format each step, so their format ranges are
        already post-fixpoints — the gate bound below (x rows at the input
        interval, h rows at the full act range) covers every timestep."""
        A, C = n.act_fmt, n.state_fmt
        sig = resolve_lut(graph, n, n.sigmoid_lut)
        tanh = resolve_lut(graph, n, n.tanh_lut)
        acc = mac_interval(n.weight_int(), n.bias_int(),
                           [(slice(0, n.d_in), in_intervals[n.inputs[0]]),
                            (slice(n.d_in, None), Interval.full(A))])
        z = checked_requant(ctx, n, acc, n.mac_shift, A, None,
                            what="gate accumulator")
        for lut in (sig, tanh):
            check_lut_domain(ctx, n, lut, z, None,
                             what="gate pre-activation")
        si = lut_interval(ctx, sig, z)          # i/f/o share the σ table
        tg = lut_interval(ctx, tanh, z)
        af, cf = A.frac_bits, C.frac_bits
        align = n.state_align_shift
        if align < 0:
            ctx.diag("EAI002", n.name,
                     f"state alignment shift {align} is negative — "
                     f"state_fmt {C} carries fewer fraction bits than "
                     f"act_fmt {A}")
            align = 0
        term = si.mul(Interval.full(C)).add(si.mul(tg).lshift(align))
        if not term.fits_int32():
            ctx.diag("EAI001", n.name,
                     f"cell-state accumulator interval {term} exceeds "
                     "the int32 word")
        c_iv = requant_interval(term, af).clip(C)
        c_a = requant_interval(c_iv, cf - af).clip(A)
        check_lut_domain(ctx, n, tanh, c_a, None,
                         what="cell-state tanh input")
        tc = lut_interval(ctx, tanh, c_a)
        h = checked_requant(ctx, n, si.mul(tc), af, A, n.outputs[0],
                            what="output-gate product")
        return {n.outputs[0]: h}

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

    def emit(self, graph: Graph, n: LSTMCellNode,
             out: Dict[str, str]) -> None:
        w_mem, b_mem = f"{n.name}_w.mem", f"{n.name}_b.mem"
        out[w_mem] = T.to_hex_lines(n.weight_int(), n.w_fmt.total_bits)
        out[b_mem] = T.to_hex_lines(n.bias_int(), 32)
        out[f"{n.name}.vhd"] = T.LSTM_CELL.substitute(
            header=T.header(graph.name, n.name), name=n.name,
            d_in=n.d_in, hidden=n.hidden, seq_len=n.seq_len,
            x_generic=T.fmt_generic("X", n.act_fmt),
            w_generic=T.fmt_generic("W", n.w_fmt),
            c_generic=T.fmt_generic("C", n.state_fmt),
            x_width=n.d_in * n.act_fmt.total_bits,
            h_width=n.hidden * n.act_fmt.total_bits,
            macs=n.macs(), n_dsp=LSTM_DSP, w_mem=w_mem, b_mem=b_mem,
            sigmoid_lut=n.sigmoid_lut, tanh_lut=n.tanh_lut,
            act_bits=n.act_fmt.total_bits)

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

    def cost(self, n: LSTMCellNode) -> NodeCost:
        per_step_macs = (n.d_in + n.hidden) * 4 * n.hidden
        mac_cycles = math.ceil(per_step_macs / LSTM_DSP)
        # elementwise state update: 4 DSP ops per hidden unit, 1/cycle each
        # on the same MAC units -> hidden cycles; + pipeline refill
        step = mac_cycles + n.hidden + PIPE
        w_bits = n.weight.size * n.w_fmt.total_bits
        b_bits = n.bias.size * 32
        return NodeCost(
            n.name, n.op,
            cycles=n.seq_len * step,
            active_cycles=n.seq_len * (mac_cycles + n.hidden),
            dsp=LSTM_DSP, bram36=brams_for(w_bits + b_bits),
            lut=150 + 12 * n.act_fmt.total_bits)


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
    has_weights = True
    family = "conv1d"
    lower_model_fn = staticmethod(lower_conv_model)

    @staticmethod
    def _frames(x: torch.Tensor, n: Conv1dNode) -> torch.Tensor:
        """(B, S, C) -> (B, out_len, kernel, C) strided tap windows."""
        from repro_torch.model.conv1d import conv1d_frames

        return conv1d_frames(x, n.kernel, n.stride)

    def wire_contract(self, n: Conv1dNode,
                      graph: Graph) -> Dict[str, FxpFormat]:
        return {n.inputs[0]: n.in_fmt, n.outputs[0]: n.out_fmt}

    def transfer(self, n: Conv1dNode, in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        # weight_int() is (K, C): axis-0 summation bounds the per-channel
        # tap accumulator, whose fan-in is exactly `kernel`.
        acc = mac_interval(n.weight_int(), n.bias_int(),
                           [(slice(None), in_intervals[n.inputs[0]])])
        out = checked_requant(
            ctx, n, acc, requant_shift(n.in_fmt, n.w_fmt, n.out_fmt),
            n.out_fmt, n.outputs[0], what="tap accumulator")
        return {n.outputs[0]: out}

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
                    fmt=n.out_fmt, mode=mode, interpret=em.interpret)
        env[n.outputs[0]] = y.reshape(B, t_out, n.channels)

    def reference(self, n: Conv1dNode, env: Dict, luts: Dict) -> None:
        x = env[n.inputs[0]]
        wq = ref_q(_const(n.weight, x), n.w_fmt)           # (K, C)
        bq = ref_bias(_const(n.bias, x), n.in_fmt, n.w_fmt)
        frames = self._frames(x, n)                        # (B, T, K, C)
        z = torch.einsum("btkc,kc->btc", frames, wq) + bq
        env[n.outputs[0]] = ref_q(z, n.out_fmt)

    def emit(self, graph: Graph, n: Conv1dNode, out: Dict[str, str]) -> None:
        w_mem, b_mem = f"{n.name}_w.mem", f"{n.name}_b.mem"
        out[w_mem] = T.to_hex_lines(n.weight_int(), n.w_fmt.total_bits)
        out[b_mem] = T.to_hex_lines(n.bias_int(), 32)
        out[f"{n.name}.vhd"] = T.CONV1D.substitute(
            header=T.header(graph.name, n.name), name=n.name,
            channels=n.channels, kernel=n.kernel, stride=n.stride,
            seq_len=n.seq_len, out_len=n.out_len,
            x_generic=T.fmt_generic("X", n.in_fmt),
            w_generic=T.fmt_generic("W", n.w_fmt),
            y_generic=T.fmt_generic("Y", n.out_fmt),
            x_width=n.seq_len * n.channels * n.in_fmt.total_bits,
            y_width=n.out_len * n.channels * n.out_fmt.total_bits,
            macs=n.macs(), n_dsp=CONV_DSP, w_mem=w_mem, b_mem=b_mem,
            rom_depth=int(n.weight.size), w_bits=n.w_fmt.total_bits,
            requant_shift=requant_shift(n.in_fmt, n.w_fmt,
                                        n.out_fmt))

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

    def cost(self, n: Conv1dNode) -> NodeCost:
        macs = n.macs()
        mac_cycles = math.ceil(macs / CONV_DSP)
        out_elems = n.out_len * n.channels
        w_bits = n.weight.size * n.w_fmt.total_bits
        b_bits = n.bias.size * 32
        return NodeCost(
            n.name, n.op,
            cycles=mac_cycles + out_elems + PIPE,
            active_cycles=mac_cycles + out_elems,
            dsp=CONV_DSP, bram36=brams_for(w_bits + b_bits),
            lut=60 + 8 * n.out_fmt.total_bits)


class ActLUTTemplate(HWTemplate):
    """Shared activation ROM entity: no netlist instance of its own (the
    act_apply wiring and the LSTM cell instantiate it where used), no
    cycles (combinational, hidden in the MAC pipeline). Its table is
    hoisted once and read through ``RTLEmulator.lookup``."""

    kind = "act_lut"
    node_cls = ActLUTNode
    in_netlist = False
    sequential = False

    def transfer(self, n: ActLUTNode, in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        return {}                               # a ROM computes nothing alone

    def prepare(self, n: ActLUTNode, graph: Graph) -> Dict:
        return {"table": n.table()}

    def execute(self, n: ActLUTNode, env: Dict, em, mode: str) -> None:
        pass                                    # a ROM computes nothing alone

    def reference(self, n: ActLUTNode, env: Dict, luts: Dict) -> None:
        pass

    def emit(self, graph: Graph, n: ActLUTNode, out: Dict[str, str]) -> None:
        mem = f"{n.name}.mem"
        out[mem] = T.to_hex_lines(n.table(), n.out_fmt.total_bits)
        out[f"{n.name}.vhd"] = T.ACT_LUT.substitute(
            header=T.header(graph.name, n.name), name=n.name, kind=n.kind,
            in_bits=n.in_fmt.total_bits, out_bits=n.out_fmt.total_bits,
            depth=n.depth, mem=mem, offset=-n.lo)

    def cost(self, n: ActLUTNode) -> NodeCost:
        rom_bits = n.depth * n.out_fmt.total_bits
        return NodeCost(n.name, n.op, cycles=0, active_cycles=0,
                        dsp=0, bram36=0,
                        lut=math.ceil(rom_bits / LUT_ROM_BITS))


class ActApplyTemplate(HWTemplate):
    """Wiring-only application of a shared ROM: combinational lookup, part
    of the act_lut vertical (it emits no entity of its own)."""

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

    def wire_contract(self, n: ActApplyNode,
                      graph: Graph) -> Dict[str, FxpFormat]:
        lut = resolve_lut(graph, n, n.lut)
        return {n.inputs[0]: lut.in_fmt, n.outputs[0]: lut.out_fmt}

    def transfer(self, n: ActApplyNode, in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        lut = resolve_lut(graph, n, n.lut)
        x = in_intervals[n.inputs[0]]
        check_lut_domain(ctx, n, lut, x, n.inputs[0], what="LUT input")
        # The lookup writes raw table values to the wire (no requant), so
        # the output interval is the table's — NOT clipped to the edge
        # format. Recording it as the pre-clip interval lets
        # ``analyze_graph``'s EAI006 pass flag an output edge too narrow for
        # the table.
        out = lut_interval(ctx, lut, x)
        ctx.saturation(n.outputs[0], out)
        return {n.outputs[0]: out}

    def execute(self, n: ActApplyNode, env: Dict, em, mode: str) -> None:
        env[n.outputs[0]] = em.lookup(n.lut, env[n.inputs[0]])

    def reference(self, n: ActApplyNode, env: Dict, luts: Dict) -> None:
        env[n.outputs[0]] = ref_act(luts[n.lut], env[n.inputs[0]])

    def emit(self, graph: Graph, n: ActApplyNode,
             out: Dict[str, str]) -> None:
        pass           # instantiates the shared LUT entity in the top level

    def instance(self, graph: Graph, n: ActApplyNode, *, enable: str,
                 done: str) -> str:
        return T.LUT_INSTANCE.substitute(
            label=f"i_{n.name}", entity=n.lut,
            wire_in=n.inputs[0], wire_out=n.outputs[0])

    def cost(self, n: ActApplyNode) -> NodeCost:
        return NodeCost(n.name, n.op, cycles=1, active_cycles=1,
                        dsp=0, bram36=0, lut=4)


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

    def wire_contract(self, n: ElementwiseNode,
                      graph: Graph) -> Dict[str, FxpFormat]:
        return {n.inputs[0]: n.a_fmt, n.inputs[1]: n.b_fmt,
                n.outputs[0]: n.out_fmt}

    def transfer(self, n: ElementwiseNode,
                 in_intervals: Dict[str, Interval], *,
                 graph: Graph, ctx: AnalysisContext) -> Dict[str, Interval]:
        a = in_intervals[n.inputs[0]]
        b = in_intervals[n.inputs[1]]
        fa, fb = n.a_fmt.frac_bits, n.b_fmt.frac_bits
        if n.kind == "mul":
            raw, from_frac = a.mul(b), fa + fb
        else:
            hi_f = max(fa, fb)
            a2, b2 = a.lshift(hi_f - fa), b.lshift(hi_f - fb)
            for side, iv in (("a", a2), ("b", b2)):
                if not iv.fits_int32():
                    ctx.diag("EAI002", n.name,
                             f"aligning operand {side!r} by "
                             f"{hi_f - (fa if side == 'a' else fb)} bits "
                             f"leaves int32 (interval {iv})",
                             edge=n.inputs[0 if side == "a" else 1])
            raw, from_frac = a2.add(b2), hi_f
        out = checked_requant(
            ctx, n, raw, from_frac - n.out_fmt.frac_bits, n.out_fmt,
            n.outputs[0], what=f"elementwise {n.kind}")
        return {n.outputs[0]: out}

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

    def emit(self, graph: Graph, n, out: Dict[str, str]) -> None:
        out[f"{n.name}.vhd"] = T.ELEMENTWISE.substitute(
            header=T.header(graph.name, n.name), name=n.name,
            a_generic=T.fmt_generic("A", n.a_fmt),
            b_generic=T.fmt_generic("B", n.b_fmt),
            y_generic=T.fmt_generic("Y", n.out_fmt),
            a_width=graph.edges[n.inputs[0]].bits,
            b_width=graph.edges[n.inputs[1]].bits,
            y_width=graph.edges[n.outputs[0]].bits,
            op_sym="*" if n.kind == "mul" else "+")

    def instance(self, graph: Graph, n, *, enable: str, done: str) -> str:
        return T.EW_INSTANCE.substitute(
            label=f"i_{n.name}", entity=n.name, enable=enable,
            wire_a=n.inputs[0], wire_b=n.inputs[1],
            wire_out=n.outputs[0], done=done)

    def cost(self, n) -> NodeCost:
        return NodeCost(n.name, n.op, cycles=1 + PIPE,
                        active_cycles=1, dsp=1, bram36=0, lut=16)


register_template(LinearTemplate())
register_template(LSTMCellTemplate())
register_template(Conv1dTemplate())
register_template(ActLUTTemplate())
register_template(ActApplyTemplate())
register_template(ElementwiseTemplate())
