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

Execution model (DESIGN.md §7, §15): the emulator is a *staged executor*.
``__init__`` hoists every weight, bias and ROM table to an int32 tensor on
the emulator's device once (``HWTemplate.prepare``). The graph walk is
built into one program per ``(iso_key, mode, device, input shape, dtype)``,
held in a small :class:`~repro_torch.rtl.program_cache.ProgramLRU`, and
every run goes through it:

* on CUDA a program is one CUDA Graph of the walk
  (:class:`~repro_torch.rtl.cuda_graph.CapturedProgram`), captured once
  and replayed on every later call — the counterpart of the reference's
  jitted walk; ``trace_count`` counts captures;
* on the CPU a program is the eager walk, which counts one "trace" when it
  is built, so the counts equal the reference's on the same calls.

The prepared *array* constants are the program's operands, not part of
it, so designs with isomorphic graphs (:func:`repro_torch.rtl.ir.iso_key`)
share one program: hand several emulators one shared ``ProgramLRU`` and
only the first builds. Kernel specs stay part of the program (they select
code paths), which is why they are part of the isomorphism key. Three
execution paths share the bit-exactness contract:

* ``mode="fused"`` (default) — one fused LSTM-window kernel launch per cell
  per window batch, one MAC kernel launch per linear/conv1d node;
* ``mode="pallas"`` — one MAC kernel launch per LSTM timestep (the
  per-step schedule, kept as a cross-check; the name is the reference's);
* ``mode="jnp"`` — the plain PyTorch versions (the name is the
  reference's).

The signature is the reference's: ``RTLEmulator(graph, use_pallas=True,
mode=None, max_programs=8, programs=None, *, device=None)``, where a false
``use_pallas`` with no ``mode`` means ``"jnp"``. ``device=None`` means
``"cuda"``, and a host without CUDA raises. On ``device="cpu"`` the
kernels' wrappers run their plain versions.

The prepared array constants are also the design's memories (BRAM and
ROM): :meth:`RTLEmulator.flip_bit` models a single-event upset in one of
them (:mod:`repro_torch.resilience`). A flipped W of an ``lstm_cell`` may
leave its ``w_fmt`` codes, which B1's ``mma`` kernel cannot take: each
cell's B1 variant is read from its own W
(:func:`repro_torch.kernels.lstm_cell_int.ops.variant`) outside any
capture and is part of the program key, so no replay loads a W into an
``mma`` program that was not cleared for it. Isomorphic siblings that
share a ``ProgramLRU`` share a program only where their variants agree.

Each run counts ``rtl.emulator.dispatch.<mode>`` and the program cache's
``rtl.emulator.cache_{hit,miss,evict}`` in the metrics registry and, when
a tracer is enabled, records an ``rtl.emulator.dispatch`` span, as the
reference does.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.quant.fixedpoint import fxp_to_int
from repro_torch.rtl.ir import Graph, iso_key
from repro_torch.rtl.oplib import get_template
from repro_torch.rtl.program_cache import ProgramLRU

Device = Optional[Union[str, torch.device]]


@dataclass
class EmulationResult:
    outputs: torch.Tensor            # int codes of the design's output edge
    outputs_f: torch.Tensor          # dequantized
    trace: Dict[str, torch.Tensor]   # per-edge int codes


def dtype_name(dtype) -> str:
    """``"int32"`` for ``torch.int32``, ``np.int32`` or ``"int32"``: the
    dtype part of a program key."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


#: the reference runs with JAX's 64-bit types off, so a 64-bit stimulus
#: becomes 32-bit before its program is looked up; the port does the same
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32}


class _ExecCtx:
    """The execution context a program's walk hands the templates.

    Templates run against ``prepared(name)``, ``lookup(lut, codes)`` and
    ``interpret`` of their executor, so a program's walk substitutes this
    view, in which the
    array constants are the program's ``params`` operand (per-node dicts of
    int32 tensors) while the static values (kernel specs) come from the
    building emulator's prepared store. Isomorphic designs have identical
    statics by construction (specs and shifts derive from shapes and
    formats, which the iso key pins), so a program built through one
    emulator's context runs correctly for any emulator with the same key.
    """

    __slots__ = ("_params", "_static", "_lut_lo", "interpret")

    def __init__(self, em: "RTLEmulator", params: Dict[str, Dict]):
        self._params = params
        self._static = em._static
        self._lut_lo = {name: n.lo for name, n in em._lut_nodes.items()}
        self.interpret = em.interpret

    def prepared(self, name: str) -> Dict:
        merged = dict(self._static.get(name, ()))
        merged.update(self._params.get(name, ()))
        return merged

    def lookup(self, lut_name: str, codes: torch.Tensor) -> torch.Tensor:
        idx = (codes - self._lut_lo[lut_name]).long()
        return self._params[lut_name]["table"][idx]


class EagerProgram:
    """The CPU's program: the walk itself, run on the caller's params."""

    __slots__ = ("walk",)

    def __init__(self, walk):
        self.walk = walk

    def __call__(self, x: torch.Tensor, params, token) -> Dict:
        return self.walk(x, params)


class RTLEmulator:
    """Runs the emitted design on integer inputs, batch-vectorized.

    A staged executor: all parameters live on ``device`` from
    construction, and each distinct ``(input shape, dtype)`` builds exactly
    once into the program LRU (``trace_count`` observes this).
    """

    MODES = ("fused", "pallas", "jnp")

    def __init__(self, graph: Graph, use_pallas: bool = True,
                 mode: Optional[str] = None, max_programs: int = 8,
                 programs: Optional[ProgramLRU] = None, *,
                 device: Device = None):
        if isinstance(use_pallas, str):
            raise TypeError(
                f"RTLEmulator's second argument is use_pallas (a bool), as "
                f"in the reference; got {use_pallas!r}: pass mode= by "
                "keyword")
        self.graph = graph
        self.use_pallas = use_pallas
        self.mode = mode if mode is not None else \
            ("fused" if use_pallas else "jnp")
        if self.mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {self.mode!r}")
        if max_programs < 1:
            raise ValueError(f"max_programs must be >= 1, got {max_programs}")
        self.device = resolve_device(device)
        # the reference's use_interpret(): not on the accelerator. Nothing
        # reads it to pick a path (the tensors' device does); a custom
        # template written to the reference's contract passes it on
        self.interpret = self.device.type != "cuda"
        self.iso_key = iso_key(graph)
        # ---- stage 0: hoist every host->device conversion, once ----------
        # each template declares its constants; ndarray values become int32
        # tensors on the device (the program's operands), the rest (kernel
        # specs) stay static
        self._lut_nodes = graph.act_luts()
        self._prep: Dict[str, Dict] = {}
        self._param_keys: Dict[str, tuple] = {}   # node -> its array fields
        self._static: Dict[str, Dict] = {}        # node -> static fields
        for n in graph.nodes:
            raw = get_template(n.op).prepare(n, graph)
            self._prep[n.name] = {
                k: (torch.as_tensor(v, dtype=torch.int32, device=self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in raw.items()}
            self._param_keys[n.name] = tuple(
                sorted(k for k, v in raw.items()
                       if isinstance(v, np.ndarray)))
            self._static[n.name] = {
                k: v for k, v in raw.items()
                if not isinstance(v, np.ndarray)}
        # names this emulator's params to a program's buffers (with their
        # tensors' versions: see _operands)
        self._params_token = object()
        self._b1_variants: tuple = ()
        self._check_codes()
        # ---- compiled-program cache ---------------------------------------
        # (iso_key, B1 variants, mode, device, shape, dtype) -> program.
        # Per-instance by default; pass a shared ProgramLRU to let
        # isomorphic emulators reuse each other's programs (DESIGN.md §15).
        self._programs = programs if programs is not None \
            else ProgramLRU(max_programs)
        self._max_programs = self._programs.max_programs
        self.trace_count = 0             # programs this emulator built
        # observability (DESIGN.md §11): cache behavior + dispatch counts
        # are plain int attrs mirrored into the process metrics registry;
        # per-dispatch spans only fire when a tracer is enabled.
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.dispatch_counts: Dict[str, int] = {}
        self.seu_flips = 0               # flip_bit calls (the SEU model)
        # pooled serving calls run_many from worker threads; the program
        # cache locks itself (ProgramLRU) and each program its buffers.
        # This lock covers a run from its program key to its replay, the
        # dispatch counts, and flip_bit's write and clear: a flip never
        # lands between a run's variant check and its params' load.
        self._lock = threading.RLock()

    def _check_codes(self) -> None:
        """Read each ``lstm_cell``'s B1 variant from its own prepared W:
        ``mma`` only for W codes of ``w_fmt``. Reading a W's range syncs,
        which a capture cannot hold and a replay never reaches, so it is
        read here, before any program is looked up, once per version of
        the tensor (the check caches its answer); the variants go into the
        program key."""
        from repro_torch.kernels.lstm_cell_int.ops import variant

        self._b1_variants = tuple(
            variant(self._static[n.name]["spec"], self._prep[n.name]["w"])
            for n in self.graph.nodes if n.op == "lstm_cell")

    # -- execution context handed to the templates ---------------------------
    def prepared(self, name: str) -> Dict:
        """The hoisted device constants of node ``name``."""
        return self._prep[name]

    def lookup(self, lut_name: str, codes: torch.Tensor) -> torch.Tensor:
        """Shared-ROM gather: table is indexed by ``code - lo``."""
        idx = (codes - self._lut_nodes[lut_name].lo).long()
        return self._prep[lut_name]["table"][idx]

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The program's operands: per-node dicts of the prepared array
        constants (weights, biases, ROM tables), keyed by node name — what
        :class:`~repro_torch.rtl.multi.MultiDesignEmulator` stacks across
        isomorphic candidates."""
        return {name: {k: self._prep[name][k] for k in keys}
                for name, keys in self._param_keys.items() if keys}

    def _operands(self):
        """``(params, token)`` of a program call. The token names these
        params and their tensors' versions, so a program's buffers are
        reloaded when the params were written in place since (a canary
        test's planted fault, an SEU model's flipped bit); the program was
        looked up by the B1 variants those params were checked for."""
        params = self.params()
        versions = tuple(t._version for arrays in params.values()
                         for t in arrays.values())
        return params, (self._params_token, versions)

    # -- graph walk ----------------------------------------------------------
    def _execute(self, x_int: torch.Tensor, mode: str,
                 params: Optional[Dict[str, Dict]] = None
                 ) -> Dict[str, torch.Tensor]:
        g = self.graph
        em = self if params is None else _ExecCtx(self, params)
        env: Dict[str, torch.Tensor] = {g.inputs[0]: x_int}
        for n in g.nodes:
            get_template(n.op).execute(n, env, em, mode)
        return env

    def _cache_key(self, shape, dtype):
        # keyed on everything the program depends on besides its operands:
        # the design's isomorphism class, the B1 variants of a fused walk
        # (see _check_codes), execution mode, the device (in the place of
        # the reference's Pallas interpret flag) and the input
        b1 = self._b1_variants if self.mode == "fused" else ()
        return (self.iso_key, b1, self.mode, str(self.device),
                tuple(int(d) for d in shape), dtype_name(dtype))

    def _program(self, x_int: torch.Tensor):
        """The program for ``x_int``'s (shape, dtype), LRU-cached.

        Returns ``(program, cache_hit, first)``: ``first`` is the env of
        the run that built a CUDA program (its warm-up, the answer to this
        call), else None. Keeps the cache observable:
        ``cache_hits``/``cache_misses``/``cache_evictions`` on the instance
        plus the matching ``rtl.emulator.cache_*`` process counters. Any
        emulator whose graph shares this emulator's iso key can run the
        program with its own params.
        """
        mx = get_metrics()
        built = {}
        self._check_codes()

        def build():
            self.trace_count += 1
            if self.device.type != "cuda":
                return EagerProgram(
                    lambda x, params: self._execute(x, self.mode, params))
            from repro_torch.rtl.cuda_graph import CapturedProgram

            prog = CapturedProgram(
                lambda params: lambda x: self._execute(x, self.mode, params),
                x_int, *self._operands())
            built["first"] = prog.take_first()
            return prog

        prog, hit, evicted = self._programs.get_or_build(
            self._cache_key(x_int.shape, x_int.dtype), build)
        if hit:
            self.cache_hits += 1
            mx.counter("rtl.emulator.cache_hit").inc()
        else:
            self.cache_misses += 1
            mx.counter("rtl.emulator.cache_miss").inc()
            if evicted:
                self.cache_evictions += evicted
                mx.counter("rtl.emulator.cache_evict").inc(evicted)
        return prog, hit, built.get("first")

    def has_program(self, shape, dtype) -> bool:
        """Whether the LRU already holds a program for this input — the
        serving router's affinity probe (:mod:`repro_torch.serving.router`).
        Read-only: does not touch LRU order. Keys include the design's iso
        key, so with a shared ProgramLRU a replica counts as warm for any
        isomorphic sibling's program."""
        return self._cache_key(shape, dtype) in self._programs

    def cache_stats(self) -> Dict[str, int]:
        """Program-cache behavior + per-mode dispatch counts, one dict."""
        with self._lock:
            return {"hits": self.cache_hits, "misses": self.cache_misses,
                    "evictions": self.cache_evictions,
                    "retraces": self.trace_count,
                    "dispatches": dict(self.dispatch_counts)}

    # -- SEU model (repro_torch.resilience): the prepared device constants
    # -- are the design's BRAM/ROM memories; flipping one bit of one word
    # -- models a single-event upset in the flashed accelerator. ----------
    def memories(self) -> List[tuple]:
        """Addressable (node, key) pairs: every sized array constant a
        fault plan may target — weights, biases, LUT tables — in the
        reference's order (nodes, then keys, sorted)."""
        return [(name, key) for name in sorted(self._prep)
                for key in self._param_keys[name]
                if self._prep[name][key].numel() > 0]

    def flip_bit(self, node: str, key: str, word: int, bit: int) -> int:
        """Flip ``bit`` of flat ``word`` (modulo the memory's size) in
        memory ``node.key``; returns the corrupted word's new int32 value.

        The XOR is done in place on the device tensor, which bumps its
        version: the next run reloads a program's params and reads B1's W
        range again (an ``lstm_cell`` whose W left ``w_fmt`` goes to
        ``simt``). The programs are still dropped, as the reference drops
        its compiled ones: a bitstream rewrite under a running design drops
        its loaded configuration, and with a shared ProgramLRU no
        isomorphic sibling replays a program built before the fault. A
        program a thread is replaying stays alive until that replay
        returns. Silent by construction: no error is raised, later outputs
        are simply wrong, and only a golden-vector canary can tell.
        """
        if not 0 <= bit <= 31:
            raise ValueError(f"bit must be in [0, 31], got {bit}")
        if node not in self._prep or key not in self._param_keys[node]:
            raise KeyError(f"no prepared memory {node!r}.{key!r}; see "
                           "memories()")
        flat = self._prep[node][key].view(-1)
        w = int(word) % flat.numel()
        # bit 31 is the int32 sign bit: its mask is -2^31 as an int32
        mask = -(1 << 31) if bit == 31 else 1 << bit
        with self._lock:
            flat[w:w + 1].bitwise_xor_(mask)
            new = int(flat[w])
            self._check_codes()
            self._programs.clear()       # rebuild on the corrupted memory
            self.seu_flips += 1
        get_metrics().counter("rtl.emulator.seu_flips").inc()
        return new

    def _result(self, env: Dict[str, torch.Tensor]) -> EmulationResult:
        out_edge = self.graph.edges[self.graph.outputs[0]]
        y = env[self.graph.outputs[0]]
        return EmulationResult(outputs=y,
                               outputs_f=y.to(torch.float32)
                               / out_edge.fmt.scale,
                               trace=env)

    def _count_dispatch(self, mode: str) -> None:
        with self._lock:
            self.dispatch_counts[mode] = self.dispatch_counts.get(mode, 0) + 1
        get_metrics().counter(f"rtl.emulator.dispatch.{mode}").inc()

    def _as_int(self, x_int) -> torch.Tensor:
        x = torch.as_tensor(x_int, device=self.device)
        return x.to(_CANONICAL.get(x.dtype, x.dtype))

    def run_int(self, x_int) -> EmulationResult:
        x_int = self._as_int(x_int)
        with self._lock:
            prog, hit, first = self._program(x_int)
            self._count_dispatch(self.mode)
            trc = get_tracer()
            if trc.enabled:                  # hoisted guard: skip the attrs
                with trc.span("rtl.emulator.dispatch", mode=self.mode,
                              shape=str(tuple(x_int.shape)), cached=hit,
                              design=self.graph.name):
                    env = first if first is not None else \
                        prog(x_int, *self._operands())
            else:
                env = first if first is not None else \
                    prog(x_int, *self._operands())
        return self._result(env)

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
        result is bit-identical to running its window alone. Distinct
        *total* batch sizes build distinct programs (the LRU absorbs the
        usual handful of shapes).
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
        """The eager walk, one MAC dispatch per timestep per cell
        (``pallas`` schedule, or the plain per-step walk for a ``jnp``
        emulator), on the same hoisted device constants and outside the
        program cache."""
        mode = "jnp" if self.mode == "jnp" else "pallas"
        self._count_dispatch("per_step")
        with get_tracer().span("rtl.emulator.dispatch", mode="per_step",
                               design=self.graph.name):
            return self._result(self._execute(self._as_int(x_int), mode))

    def run_per_step(self, x) -> EmulationResult:
        return self.run_int_per_step(self._quantize(x))


def outputs_by_mode(graph: Graph, x_int,
                    modes: Sequence[str] = RTLEmulator.MODES, *,
                    device: Device = None) -> Dict[str, np.ndarray]:
    """Run the same integer stimulus through each execution path; int64
    outputs keyed by mode name (one fresh emulator per mode)."""
    return {m: RTLEmulator(graph, mode=m, device=device).run_int(x_int)
            .outputs.cpu().numpy().astype(np.int64)
            for m in modes}


# --------------------------------------------------------------------------- #
# Float oracle: identical semantics expressed with fxp_quantize only
# --------------------------------------------------------------------------- #


def reference_apply(graph: Graph, x, *,
                    device: Device = None) -> torch.Tensor:
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


def assert_bit_exact(graph: Graph, x, use_pallas: bool = True,
                     mode: Optional[str] = None, *,
                     device: Device = None) -> None:
    """Raises AssertionError on the first integer mismatch (test helper)."""
    res = RTLEmulator(graph, use_pallas, mode, device=device).run(x)
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
