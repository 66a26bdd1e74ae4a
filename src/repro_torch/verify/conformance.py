"""Differential conformance — the Elastic Node's pass/fail logic (port of
``repro/verify/conformance.py``).

One design, three independent implementations of its integer semantics (the
``fused``/``pallas``/``jnp`` emulator paths: B1 and B2's CUDA kernels, B2
once per LSTM step, and the plain PyTorch versions) and one float oracle
(``reference_apply``, built only from ``fxp_quantize``). Conformance means:

1. **mutual bit-exactness** — every execution mode produces the *same int32
   codes* for the same stimulus (a divergence is a miscompiled schedule);
2. **oracle agreement within budget** — int output vs the float oracle stays
   within a per-design error budget in output LSBs, derived from the fixed-
   point wordlengths: inside the §4 exactness envelope the budget is 0
   (exact equality is the contract), and any slack must be *declared* by a
   template (``HWTemplate.error_budget_lsb``), never assumed;
3. **golden replay** (when a stored vector set is supplied) — responses
   match the checked-in set integer-for-integer.

Every entry point that runs the emulator takes ``device=``: ``None`` means
CUDA (and raises on a host without it); ``"cpu"`` runs the kernels' plain
versions. The reports are field for field the reference's.
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.verify.vectors import VectorSet, generate_vectors

DEFAULT_MODES = ("fused", "pallas", "jnp")

Device = Optional[Union[str, torch.device]]


@dataclass
class ConformanceReport:
    """The structured verdict of one differential run.

    ``passed`` is the conjunction of every *enforced* sub-check; individual
    fields keep the evidence so a failure is debuggable from the artifact
    alone.
    """

    design: str
    target: str
    passed: bool = True
    # differential half (RTL targets; empty for host-executed targets)
    modes: Tuple[str, ...] = ()
    modes_bit_exact: bool = True
    mode_max_diff: Dict[str, int] = field(default_factory=dict)
    oracle_max_lsb: float = 0.0
    error_budget_lsb: int = 0
    oracle_within_budget: bool = True
    n_vectors: int = 0
    golden_match: Optional[bool] = None      # None: no stored set replayed
    # protocol half
    protocol: Optional[dict] = None
    notes: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def summary(self) -> str:
        bits = [f"{self.design}[{self.target}]",
                "PASS" if self.passed else "FAIL"]
        if self.modes:
            bits.append(f"modes={'=='.join(self.modes)}"
                        f"{'(exact)' if self.modes_bit_exact else '(DIVERGED)'}")
            bits.append(f"oracle<= {self.oracle_max_lsb:g} LSB "
                        f"(budget {self.error_budget_lsb})")
            bits.append(f"vectors={self.n_vectors}")
        if self.golden_match is not None:
            bits.append(f"golden={'ok' if self.golden_match else 'MISMATCH'}")
        if self.protocol is not None:
            bits.append(f"protocol={'ok' if self.protocol.get('passed') else 'FAIL'}")
        return "  ".join(bits)


def graph_error_budget_lsb(graph) -> int:
    """The design's allowed |int − oracle| at the output, in output LSBs.

    Every built-in template is exact inside the §4 envelope, so each
    contributes 0; a node's declared slack (``HWTemplate.error_budget_lsb``)
    bounds its output error in its own LSBs, and downstream requantization
    never amplifies an LSB-scale error by more than 1 code, so the sum is a
    conservative bound for the whole graph (DESIGN.md §10).
    """
    from repro_torch.rtl.oplib import get_template

    return int(sum(get_template(n.op).error_budget_lsb(n)
                   for n in graph.nodes))


@contextlib.contextmanager
def exact_f32_matmul():
    """f32 matmuls in full precision for the scope, whatever the process's
    TF32 setting: the oracle's ``src @ wq`` and ``einsum`` are exact only
    in IEEE f32 (the §4 envelope keeps every accumulator below 2**24),
    and TF32 would move codes by LSBs. The per-backend setting is the one
    torch reads for CUDA matmuls whichever API set the global (the legacy
    ``allow_tf32`` / ``set_float32_matmul_precision`` included)."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = prev


def oracle_codes(graph, stimulus_f: np.ndarray, *,
                 device: Device = None) -> np.ndarray:
    """The float oracle's output, as int codes of the output edge format,
    computed on ``device`` with f32 matmuls held in full precision."""
    from repro_torch.rtl.emulator import reference_apply

    fmt = graph.edges[graph.outputs[0]].fmt
    with exact_f32_matmul():
        ref = reference_apply(graph, np.asarray(stimulus_f, np.float32),
                              device=device)
        codes = torch.round(ref * fmt.scale)
    return codes.cpu().numpy().astype(np.int64)


def run_conformance(graph, vectors: Optional[VectorSet] = None, *,
                    modes: Sequence[str] = DEFAULT_MODES,
                    target: str = "rtl",
                    extra_stimulus: Optional[np.ndarray] = None,
                    replay_golden: Optional[bool] = None,
                    device: Device = None) -> ConformanceReport:
    """Differential-execute ``graph`` over a golden vector set on
    ``device``.

    ``vectors=None`` generates the design's deterministic set on the fly;
    passing a loaded set additionally replays its stored responses
    (``golden_match`` — ``replay_golden=False`` opts a freshly generated,
    never-stored set out of that check). ``extra_stimulus`` appends
    caller-provided int code rows (e.g. fuzz samples from a template's
    ``sample_inputs`` hook).

    Each differential sub-check runs in its own span (``verify.mode`` per
    execution mode, ``verify.oracle``, ``verify.golden_replay``) so a
    failing mode is attributable in the captured trace, not just the
    report.
    """
    from repro_torch.obs import get_tracer
    from repro_torch.rtl.emulator import outputs_by_mode

    trc = get_tracer()
    rep = ConformanceReport(design=graph.name, target=target,
                            modes=tuple(modes))
    with trc.span("verify.conformance", design=graph.name,
                  target=target) as root:
        if replay_golden is None:
            replay_golden = vectors is not None
        if vectors is None:
            with trc.span("verify.generate_vectors", design=graph.name):
                vectors = generate_vectors(graph, device=device)
        stim = vectors.stimulus
        if extra_stimulus is not None:
            stim = np.concatenate([stim,
                                   np.asarray(extra_stimulus, np.int32)],
                                  axis=0)
        rep.n_vectors = int(stim.shape[0])

        # 1 — every execution mode must agree integer-for-integer
        outs = {}
        for m in rep.modes:
            with trc.span("verify.mode", mode=m, design=graph.name):
                outs[m] = outputs_by_mode(graph, stim, modes=(m,),
                                          device=device)[m]
        base_mode = rep.modes[0]
        base = outs[base_mode]
        for m in rep.modes[1:]:
            diff = int(np.max(np.abs(outs[m] - base))) if base.size else 0
            rep.mode_max_diff[f"{base_mode}-vs-{m}"] = diff
            if diff != 0:
                rep.modes_bit_exact = False
                rep.notes.append(f"mode {m!r} diverges from {base_mode!r} "
                                 f"by up to {diff} codes")

        # 2 — int vs float oracle, within the declared LSB budget
        with trc.span("verify.oracle", design=graph.name) as so:
            ref_int = oracle_codes(graph, stim.astype(np.float32)
                                   / vectors.in_fmt.scale, device=device)
            rep.error_budget_lsb = graph_error_budget_lsb(graph)
            rep.oracle_max_lsb = float(np.max(np.abs(base - ref_int))) \
                if base.size else 0.0
            rep.oracle_within_budget = \
                rep.oracle_max_lsb <= rep.error_budget_lsb
            so.set_attrs(max_lsb=rep.oracle_max_lsb,
                         budget=rep.error_budget_lsb)
        if not rep.oracle_within_budget:
            rep.notes.append(
                "int output deviates from the fxp_quantize oracle by "
                f"{rep.oracle_max_lsb:g} LSB > budget "
                f"{rep.error_budget_lsb}")

        # 3 — golden replay: stored responses must still be what the
        # design does
        if replay_golden:
            with trc.span("verify.golden_replay", design=graph.name) as sg:
                n = vectors.response.shape[0]
                rep.golden_match = bool(np.array_equal(base[:n],
                                                       vectors.response))
                sg.set_attrs(match=rep.golden_match)
            if not rep.golden_match:
                bad = np.argwhere(base[:n] != vectors.response)
                rep.notes.append(
                    f"stored golden responses mismatch at {len(bad)} "
                    f"positions (first {bad[0].tolist()})")

        rep.passed = (rep.modes_bit_exact and rep.oracle_within_budget
                      and rep.golden_match is not False)
        root.set_attrs(passed=rep.passed)
    return rep


def run_conformance_batch(graphs, *,
                          modes: Sequence[str] = DEFAULT_MODES,
                          stimulus: Optional[np.ndarray] = None,
                          device: Device = None) -> List[ConformanceReport]:
    """Differential conformance over K program-isomorphic candidates in
    one batched sweep on ``device`` — the DSE feasibility oracle
    (DESIGN.md §15).

    The base path runs every design at once: one dispatch through
    :class:`~repro_torch.rtl.multi.MultiDesignEmulator` (on CUDA one CUDA
    Graph of the K designs' ``fused`` walks; labelled ``"vmap-jnp"`` as in
    the reference). Each per-design sequential mode then cross-checks its
    candidate through a *shared* :class:`~repro_torch.rtl.program_cache.
    ProgramLRU` — isomorphic designs share the program, so each mode
    builds once for all K, not once per candidate. Reports mirror
    :func:`run_conformance`: mutual bit-exactness (the design axis vs every
    sequential mode) plus the float oracle within the declared LSB budget,
    one report per design.
    """
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.rtl.multi import MultiDesignEmulator
    from repro_torch.rtl.program_cache import ProgramLRU

    graphs = list(graphs)
    multi = MultiDesignEmulator(graphs, device=device)  # checks isomorphism
    if stimulus is None:
        stimulus = generate_vectors(graphs[0], device=device).stimulus
    stim = np.asarray(stimulus, np.int32)
    in_fmt = graphs[0].edges[graphs[0].inputs[0]].fmt

    batched = multi.run_int(stim).outputs.cpu().numpy() \
        .astype(np.int64)                                # (K, B, ...)
    shared = {m: ProgramLRU(4) for m in modes}
    reports: List[ConformanceReport] = []
    for kidx, g in enumerate(graphs):
        rep = ConformanceReport(design=g.name, target="rtl",
                                modes=("vmap-jnp",) + tuple(modes))
        rep.n_vectors = int(stim.shape[0])
        base = batched[kidx]
        for m in modes:
            em = RTLEmulator(g, mode=m, programs=shared[m], device=device)
            out = em.run_int(stim).outputs.cpu().numpy().astype(np.int64)
            diff = int(np.max(np.abs(out - base))) if base.size else 0
            rep.mode_max_diff[f"vmap-jnp-vs-{m}"] = diff
            if diff != 0:
                rep.modes_bit_exact = False
                rep.notes.append(
                    f"sequential mode {m!r} diverges from the vmapped "
                    f"design axis by up to {diff} codes")
        ref_int = oracle_codes(g, stim.astype(np.float32) / in_fmt.scale,
                               device=device)
        rep.error_budget_lsb = graph_error_budget_lsb(g)
        rep.oracle_max_lsb = float(np.max(np.abs(base - ref_int))) \
            if base.size else 0.0
        rep.oracle_within_budget = \
            rep.oracle_max_lsb <= rep.error_budget_lsb
        if not rep.oracle_within_budget:
            rep.notes.append(
                "int output deviates from the fxp_quantize oracle by "
                f"{rep.oracle_max_lsb:g} LSB > budget "
                f"{rep.error_budget_lsb}")
        rep.passed = rep.modes_bit_exact and rep.oracle_within_budget
        reports.append(rep)
    return reports


def fuzz_template(kind: str, *, seed: int = 0, batch: int = 8,
                  modes: Sequence[str] = DEFAULT_MODES,
                  device: Device = None) -> Optional[ConformanceReport]:
    """Property-check one registered hardware template on ``device``.

    Builds the template's ``probe_graph`` with a seeded numpy rng, draws
    stimulus from its ``sample_inputs`` hook (corner rows + seeded codes),
    and runs the full differential check. Returns ``None`` for templates
    with no standalone compute (``probe_graph() is None``) — they are
    covered through the kinds that instantiate them.
    """
    from repro_torch.quant.fixedpoint import fxp_to_int
    from repro_torch.rtl.oplib import get_template

    tmpl = get_template(kind)
    rng = np.random.Generator(np.random.PCG64(seed))
    graph = tmpl.probe_graph(rng)
    if graph is None:
        return None
    node = next(n for n in graph.nodes if n.op == kind)
    x = tmpl.sample_inputs(node, graph, rng, batch=batch)
    in_fmt = graph.edges[graph.inputs[0]].fmt
    codes = fxp_to_int(torch.from_numpy(x), in_fmt).numpy().astype(np.int32)
    return run_conformance(graph, modes=modes, extra_stimulus=codes,
                           device=device)


# --------------------------------------------------------------------------- #
# Canary: the in-service health-check slice of the golden protocol
# --------------------------------------------------------------------------- #


@dataclass
class CanaryResult:
    """Verdict of one golden-slice health probe (``canary_check``)."""

    design: str
    n: int
    passed: bool
    n_mismatch: int = 0
    max_diff: int = 0
    path: str = "int"                # "int" (emulator codes) or "float"

    def to_dict(self) -> dict:
        return asdict(self)


def _host(a) -> np.ndarray:
    """A deployment's answer as a host numpy array (bf16, which numpy
    lacks, widened to f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def canary_check(dep, vectors: VectorSet, *, n: int = 4) -> CanaryResult:
    """Replay the first ``n`` golden rows through a *live* deployment and
    demand integer-exact responses.

    This exercises the deployment instance actually serving traffic, on
    its own device: for RTL deployments (anything holding an
    ``emulator``) the int codes go straight through its emulator, whose
    prepared memories are exactly what an upset corrupts; other
    deployments answer in float and are re-encoded at the output format.
    """
    vs = vectors.head(n)
    emu = getattr(dep, "emulator", None)
    if emu is not None:
        got = _host(emu.run_int(vs.stimulus).outputs).astype(np.int64)
        path = "int"
    else:
        out = _host(dep(np.asarray(vs.stimulus_f())))
        got = np.asarray(np.rint(np.asarray(out, np.float32)
                                 * vs.out_fmt.scale), np.int64)
        path = "float"
    want = np.asarray(vs.response, np.int64)
    got = got.reshape(want.shape)
    diff = np.abs(got - want)
    return CanaryResult(design=vs.design, n=vs.n_vectors,
                        passed=bool(np.array_equal(got, want)),
                        n_mismatch=int(np.count_nonzero(diff)),
                        max_diff=int(diff.max()) if diff.size else 0,
                        path=path)


# --------------------------------------------------------------------------- #
# Deployment-level entry (what Deployment.verify calls)
# --------------------------------------------------------------------------- #


def _leaves(out) -> List[np.ndarray]:
    """A deployment's answer (a tensor, an array, or nested tuples, lists
    and dicts of them) as host float32 arrays, in tree order."""
    from repro_torch.model.layers import tree_leaves

    return [np.asarray(_host(leaf), np.float32)
            for leaf in tree_leaves(out)]


def verify_deployment(dep, args=None, *, model: str, model_flops: float,
                      hw=None, protocol=None, oracle=None,
                      modes: Sequence[str] = DEFAULT_MODES,
                      vectors: Optional[VectorSet] = None
                      ) -> ConformanceReport:
    """Run any :class:`~repro_torch.core.target.Deployment` through the
    Elastic Node conformance protocol; the uniform body behind
    ``Deployment.verify``.

    RTL deployments (anything carrying a lowered ``graph``) get the full
    differential check over golden vectors, on the deployment's own
    ``device``, plus the measurement protocol. Host-executed deployments get
    the measurement protocol plus, when an ``oracle`` callable is provided,
    a float comparison of the deployed executable against it.
    """
    from repro_torch.verify.protocol import run_protocol

    graph = getattr(dep, "graph", None)
    if graph is not None:
        device = getattr(dep, "device", None)
        vs = vectors if vectors is not None else generate_vectors(
            graph, device=device)
        rep = run_conformance(graph, vs, modes=modes,
                              target=dep.target or "rtl",
                              replay_golden=vectors is not None,
                              device=device)
        if args is None:
            args = (vs.stimulus_f()[:1],)
    else:
        rep = ConformanceReport(design=model, target=dep.target or "xla")
        if oracle is not None and args is not None:
            got, want = _leaves(dep(*args)), _leaves(oracle(*args))
            err, tol, shapes_ok = 0.0, 0.0, len(got) == len(want)
            for a, b in zip(got, want):
                if a.shape != b.shape:
                    shapes_ok = False
                    break
                if a.size:
                    err = max(err, float(np.max(np.abs(a - b))))
                    tol = max(tol, 1e-4 * max(1.0,
                                              float(np.max(np.abs(b)))))
            if not shapes_ok or err > tol:
                rep.passed = False
                rep.notes.append("deployed executable deviates from oracle "
                                 f"by {err:g} (tol {tol:g})"
                                 if shapes_ok else
                                 "deployed executable and oracle disagree "
                                 "on output structure")
            else:
                rep.notes.append(f"oracle agreement: max|Δ|={err:g} "
                                 f"<= {tol:g}")
    if args is not None:
        prot = run_protocol(dep, args, model=model, model_flops=model_flops,
                            hw=hw, protocol=protocol)
        rep.protocol = prot.to_dict()
        if not prot.passed:
            rep.passed = False
            rep.notes.append("measurement protocol failed: " + "; ".join(
                c.name for c in prot.checks if c.enforced and not c.passed))
    return rep
