"""Bit-exact integer emulator of the emitted RTL — the backend's verifier
(port of ``repro/rtl/emulator.py``).

Every IR node's integer semantics (DESIGN.md §4) are implemented twice, on
the node's registered :class:`~repro_torch.rtl.oplib.HWTemplate`:

* ``HWTemplate.reference`` — the float oracle, built *only* from
  ``fxp_quantize`` / the hard activations (driven by
  :func:`reference_apply`);
* ``HWTemplate.execute`` — int32 arithmetic (what the DSP slices compute),
  with hand-written CUDA kernels for the LSTM-cell window and the MAC
  (driven by :class:`RTLEmulator`).

The contract is exact equality, integer for integer: ``emulator.run(x)``
must satisfy ``y_int == round(reference_apply(x) * 2**f)`` for every
sample, provided formats pass ``ir.validate_formats``.

Execution model: ``__init__`` hoists every weight, bias and ROM table to an
int32 tensor on the emulator's device once (``HWTemplate.prepare``); each
run walks the graph eagerly on that device. Three execution paths share the
bit-exactness contract:

* ``mode="fused"`` (default) — one fused LSTM-window kernel launch per cell
  per window batch, one MAC kernel launch per linear/conv1d node;
* ``mode="pallas"`` — one MAC kernel launch per LSTM timestep (the
  per-step schedule, kept as a cross-check; the name is the reference's);
* ``mode="jnp"`` — the plain PyTorch versions (the name is the
  reference's).

``device=None`` means ``"cuda"``, and a host without CUDA raises. On
``device="cpu"`` the kernels' wrappers run their plain versions.

Each run counts ``rtl.emulator.dispatch.<mode>`` in the metrics registry
and, when a tracer is enabled, records an ``rtl.emulator.dispatch`` span,
as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.quant.fixedpoint import fxp_to_int
from repro_torch.rtl.ir import Graph
from repro_torch.rtl.oplib import get_template


@dataclass
class EmulationResult:
    outputs: torch.Tensor            # int codes of the design's output edge
    outputs_f: torch.Tensor          # dequantized
    trace: Dict[str, torch.Tensor]   # per-edge int codes


class RTLEmulator:
    """Runs the emitted design on integer inputs, batch-vectorized, with
    every parameter resident on ``device`` from construction."""

    MODES = ("fused", "pallas", "jnp")

    def __init__(self, graph: Graph, mode: str = "fused",
                 device: Optional[Union[str, torch.device]] = None):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        self.graph = graph
        self.mode = mode
        self.device = resolve_device(device)
        # hoist every host->device conversion, once: each template declares
        # its constants; ndarray values become int32 tensors on the device,
        # the rest (kernel specs) are kept as they are
        self._lut_nodes = graph.act_luts()
        self._prep: Dict[str, Dict] = {}
        for n in graph.nodes:
            raw = get_template(n.op).prepare(n, graph)
            self._prep[n.name] = {
                k: (torch.as_tensor(v, dtype=torch.int32, device=self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in raw.items()}
        self.dispatch_counts: Dict[str, int] = {}

    # -- execution context handed to the templates ---------------------------
    def prepared(self, name: str) -> Dict:
        """The hoisted device constants of node ``name``."""
        return self._prep[name]

    def lookup(self, lut_name: str, codes: torch.Tensor) -> torch.Tensor:
        """Shared-ROM gather: table is indexed by ``code - lo``."""
        idx = (codes - self._lut_nodes[lut_name].lo).long()
        return self._prep[lut_name]["table"][idx]

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-node dicts of the prepared array constants (weights, biases,
        ROM tables), keyed by node name."""
        out = {}
        for name, prep in self._prep.items():
            arrays = {k: v for k, v in prep.items()
                      if isinstance(v, torch.Tensor)}
            if arrays:
                out[name] = arrays
        return out

    # -- graph walk ----------------------------------------------------------
    def _execute(self, x_int: torch.Tensor, mode: str
                 ) -> Dict[str, torch.Tensor]:
        g = self.graph
        env: Dict[str, torch.Tensor] = {g.inputs[0]: x_int}
        for n in g.nodes:
            get_template(n.op).execute(n, env, self, mode)
        return env

    def _result(self, env: Dict[str, torch.Tensor]) -> EmulationResult:
        out_edge = self.graph.edges[self.graph.outputs[0]]
        y = env[self.graph.outputs[0]]
        return EmulationResult(outputs=y,
                               outputs_f=y.to(torch.float32)
                               / out_edge.fmt.scale,
                               trace=env)

    def _count_dispatch(self, mode: str) -> None:
        self.dispatch_counts[mode] = self.dispatch_counts.get(mode, 0) + 1
        get_metrics().counter(f"rtl.emulator.dispatch.{mode}").inc()

    def _as_int(self, x_int) -> torch.Tensor:
        return torch.as_tensor(x_int, device=self.device)

    def run_int(self, x_int) -> EmulationResult:
        x_int = self._as_int(x_int)
        self._count_dispatch(self.mode)
        trc = get_tracer()
        if trc.enabled:                      # hoisted guard: skip the attrs
            with trc.span("rtl.emulator.dispatch", mode=self.mode,
                          shape=str(tuple(x_int.shape)),
                          design=self.graph.name):
                return self._result(self._execute(x_int, self.mode))
        return self._result(self._execute(x_int, self.mode))

    def _quantize(self, x) -> torch.Tensor:
        in_fmt = self.graph.edges[self.graph.inputs[0]].fmt
        x = torch.as_tensor(x, device=self.device)
        return fxp_to_int(x, in_fmt).to(torch.int32)

    def run(self, x) -> EmulationResult:
        return self.run_int(self._quantize(x))

    # -- batched-throughput entry -------------------------------------------
    def run_many(self, xs) -> Union[EmulationResult, List[EmulationResult]]:
        """Many independent float windows in ONE dispatch.

        A plain array is treated as an already-stacked batch (same as
        :meth:`run`). A list/tuple of ``(B_i, ...)`` windows is concatenated
        along batch, executed once, and split back into one
        :class:`EmulationResult` per input — rows are independent, so each
        result is bit-identical to running its window alone.
        """
        if not isinstance(xs, (list, tuple)):
            return self.run(xs)
        xs = [torch.as_tensor(x, device=self.device) for x in xs]
        sizes = [int(x.shape[0]) for x in xs]
        res = self.run(torch.cat(xs, dim=0))
        out, off = [], 0
        for s in sizes:
            sl = slice(off, off + s)
            off += s
            out.append(EmulationResult(
                outputs=res.outputs[sl], outputs_f=res.outputs_f[sl],
                trace={k: v[sl] for k, v in res.trace.items()}))
        return out

    # -- per-step schedule ---------------------------------------------------
    def run_int_per_step(self, x_int) -> EmulationResult:
        """One MAC dispatch per timestep per cell (``pallas`` schedule, or
        the plain per-step walk for a ``jnp`` emulator), on the same
        hoisted device constants."""
        mode = "jnp" if self.mode == "jnp" else "pallas"
        self._count_dispatch("per_step")
        with get_tracer().span("rtl.emulator.dispatch", mode="per_step",
                               design=self.graph.name):
            return self._result(self._execute(self._as_int(x_int), mode))

    def run_per_step(self, x) -> EmulationResult:
        return self.run_int_per_step(self._quantize(x))


def outputs_by_mode(graph: Graph, x_int,
                    modes: Sequence[str] = RTLEmulator.MODES, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, np.ndarray]:
    """Run the same integer stimulus through each execution path; int64
    outputs keyed by mode name (one fresh emulator per mode)."""
    return {m: RTLEmulator(graph, mode=m, device=device).run_int(x_int)
            .outputs.cpu().numpy().astype(np.int64)
            for m in modes}


# --------------------------------------------------------------------------- #
# Float oracle: identical semantics expressed with fxp_quantize only
# --------------------------------------------------------------------------- #


def reference_apply(graph: Graph, x, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Tensor:
    """The fxp_quantize reference the emulator must match bit-for-bit.

    Registry-dispatched like the integer walk: every node's float semantics
    live on its template (``HWTemplate.reference``). All values are f32;
    they are exact inside the §4 envelope (``ir.validate_formats``).
    """
    from repro_torch.rtl.oplib import ref_q

    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    env = {graph.inputs[0]: ref_q(x, graph.edges[graph.inputs[0]].fmt)}
    luts = graph.act_luts()
    for n in graph.nodes:
        get_template(n.op).reference(n, env, luts)
    return env[graph.outputs[0]]


def assert_bit_exact(graph: Graph, x, mode: str = "fused", *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """Raises AssertionError on the first integer mismatch (test helper)."""
    res = RTLEmulator(graph, mode=mode, device=device).run(x)
    ref = reference_apply(graph, x, device=device)
    fmt = graph.edges[graph.outputs[0]].fmt
    ref_int = torch.round(ref * fmt.scale).cpu().numpy().astype(np.int64)
    got = res.outputs.cpu().numpy().astype(np.int64)
    if not np.array_equal(got, ref_int):
        bad = np.argwhere(got != ref_int)
        raise AssertionError(
            f"emulator != fxp reference at {len(bad)} positions; first "
            f"{bad[0].tolist()}: got {got[tuple(bad[0])]} "
            f"ref {ref_int[tuple(bad[0])]} (fmt {fmt})")
