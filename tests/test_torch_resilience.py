"""PyTorch port, the resilience layer (fault injection, guarded
deployments, chaos scenarios), the SEU model of the emulator, ``RunTrace``
/ ``capture`` and the ``FailureInjector``, against the JAX package on the
CPU.

Every case of the reference's ``tests/test_resilience.py`` is mirrored one
for one on the port (members run on the CPU, the kernels' plain versions).
The parity tests drive both packages through one script: the same
memories and flipped words, the emulator's codes after every bit flip of
every memory, byte-equal ``ResilienceReport.to_json()`` for the acceptance
scenario and for the workflow test's scenario (which reports FAIL in the
reference on that test's own params, and so in the port), equal farm and
pool states with guarded members under one virtual clock, equal trace
artifacts under a fake clock and equal failure schedules. The B1 routing
rule for a W outside its format (a flipped bit 7) is held here on the
routing and the program keys; the card tests hold its kernels.
"""
import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax

    import repro.serving as jserving
    from repro import obs as jobs
    from repro.configs import get_config as j_get_config
    from repro.core import workflow as jworkflow
    from repro.core.creator import Creator as JCreator
    from repro.core.report import DesignReport as JDesignReport
    from repro.core.target import XLADeployment
    from repro.core.types import SHAPES_LSTM as J_SHAPES_LSTM
    from repro.energy.hw import XC7S15 as J_XC7S15
    from repro.model.layers import init_params as j_init_params
    from repro.model.lstm import lstm_schema as j_lstm_schema
    from repro.resilience import ChaosSpec as JChaosSpec
    from repro.resilience import FallbackPolicy as JFallbackPolicy
    from repro.resilience import FaultPlan as JFaultPlan
    from repro.resilience import FaultSpec as JFaultSpec
    from repro.resilience import GuardedDeployment as JGuardedDeployment
    from repro.resilience import GuardPolicy as JGuardPolicy
    from repro.resilience import VirtualClock as JVirtualClock
    from repro.resilience import run_chaos as j_run_chaos
    from repro.rtl import ir as jir
    from repro.rtl.backend import RTLExecutable as JRTLExecutable
    from repro.rtl.emulator import RTLEmulator as JRTLEmulator
    from repro.rtl.emulator import reference_apply as j_reference_apply
    from repro.runtime.failures import FailureInjector as JFailureInjector
    from repro.runtime.failures import PreemptionError as JPreemptionError
    from repro.verify import vectors as jvec

from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.creator import Creator
from repro_torch.core.report import DesignReport
from repro_torch.core.target import Deployment, TorchDeployment
from repro_torch.core.types import SHAPES_LSTM
from repro_torch.core.workflow import Workflow, chaos_fallback
from repro_torch.energy.hw import XC7S15
from repro_torch.kernels.lstm_cell_int import kernel as b1_kernel
from repro_torch.kernels.lstm_cell_int import ops as b1_ops
from repro_torch.launch import elastic_workflow as tew
from repro_torch.obs import MetricsRegistry
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.resilience import (CLOSED, HALF_OPEN, OPEN, ChaosSpec,
                                    CircuitBreaker, FallbackPolicy,
                                    FaultPlan, FaultSpec, FaultyDeployment,
                                    GuardedDeployment, GuardExhausted,
                                    GuardPolicy, TransientFault,
                                    VirtualClock, run_chaos)
from repro_torch.rtl import ir as tir
from repro_torch.rtl.backend import RTLExecutable
from repro_torch.rtl.emulator import RTLEmulator, reference_apply
from repro_torch.rtl.program_cache import ProgramLRU
from repro_torch.runtime.failures import FailureInjector, PreemptionError
from repro_torch.serving import DeploymentPool
from repro_torch.verify import canary_check, generate_vectors
from repro_torch.verify import vectors as tvec

CPU = "cpu"
ARCHS = ("elastic-lstm", "elastic-conv1d")
PLAN_PATH = str(Path(__file__).resolve().parents[1] / "examples"
                / "chaos_plan.json")


@pytest.fixture(scope="module")
def lstm_graph():
    graph, _, _ = tvec.canonical_graph("elastic-lstm")
    return graph


@pytest.fixture(scope="module")
def lstm_vectors(lstm_graph):
    return generate_vectors(lstm_graph, device=CPU)


def _rtl_dep(graph):
    return RTLExecutable(graph=graph, artifacts={}, hw=XC7S15, device=CPU)


def _xla_fallback(graph):
    return TorchDeployment(fn=lambda x: reference_apply(graph, x, device=CPU),
                           hw=XC7S15, device=CPU)


def _j_rtl_dep(graph):
    return JRTLExecutable(graph=graph, artifacts={}, hw=J_XC7S15)


def _j_xla_fallback(graph):
    return XLADeployment(fn=jax.jit(lambda x: j_reference_apply(graph, x)),
                         hw=J_XC7S15)


# --------------------------------------------------------------------------- #
# FaultSpec / FaultPlan (the reference's cases)
# --------------------------------------------------------------------------- #


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec(kind="gamma_ray", at_call=0)
    with pytest.raises(ValueError, match="never fires"):
        FaultSpec(kind="transient")              # no trigger at all
    with pytest.raises(ValueError, match="probability"):
        FaultSpec(kind="transient", probability=1.5)
    with pytest.raises(ValueError, match="bit"):
        FaultSpec(kind="bitflip", at_call=0, bit=32)
    with pytest.raises(ValueError, match="delay_s"):
        FaultSpec(kind="latency", at_call=0, delay_s=-1.0)


def test_fault_plan_json_round_trip(tmp_path):
    plan = FaultPlan(seed=2024, faults=(
        FaultSpec(kind="transient", at_call=2),
        FaultSpec(kind="bitflip", at_call=9, memory="lstm_cell_l0.w",
                  word=3, bit=31),
        FaultSpec(kind="latency", probability=0.25, once=False,
                  delay_s=0.5)))
    back = FaultPlan.from_json(plan.to_json())
    assert back == plan
    p = tmp_path / "plan.json"
    plan.save(str(p))
    assert FaultPlan.load(str(p)) == plan
    # the checked-in CI scenario must stay loadable
    shipped = FaultPlan.load(PLAN_PATH)
    assert {f.kind for f in shipped.faults} == {"transient", "latency",
                                                "bitflip"}
    # and both packages write the same artifact
    jplan = JFaultPlan(seed=2024, faults=tuple(
        JFaultSpec(**dataclasses.asdict(f)) for f in plan.faults))
    assert plan.to_json() == jplan.to_json()


def test_virtual_clock():
    clk = VirtualClock(start=1.0)
    assert clk() == clk.now() == 1.0
    clk.sleep(0.5)
    clk.advance(0.25)
    clk.sleep(-3.0)                              # never goes backwards
    assert clk.now() == 1.75


# --------------------------------------------------------------------------- #
# SEU model: emulator memories + flip_bit
# --------------------------------------------------------------------------- #


def test_emulator_memories_and_flip_bit(lstm_graph, lstm_vectors):
    dep = _rtl_dep(lstm_graph)
    emu = dep.emulator
    mems = emu.memories()
    assert ("lstm_cell_l0", "w") in mems and \
        ("hard_sigmoid_lut", "table") in mems
    before = emu.prepared("lstm_cell_l0")["w"].clone().reshape(-1)
    new = emu.flip_bit("lstm_cell_l0", "w", 0, 7)
    assert new == int(before[0]) ^ (1 << 7)
    assert emu.seu_flips == 1
    # silent: no exception, but the canary catches it on the rail rows
    assert not canary_check(dep, lstm_vectors, n=4).passed
    # XOR is an involution: re-flipping restores bit-exact behavior
    emu.flip_bit("lstm_cell_l0", "w", 0, 7)
    assert canary_check(dep, lstm_vectors, n=4).passed


def test_flip_bit_sign_bit_and_word_wrap(lstm_graph):
    emu = _rtl_dep(lstm_graph).emulator
    flat = emu.prepared("linear_head")["w"].clone().numpy().reshape(-1)
    # bit 31 (the int32 sign bit) must not overflow int32 arithmetic
    u = flat.copy().view(np.uint32)
    u[0] ^= np.uint32(1) << np.uint32(31)
    expected = int(u.view(np.int32)[0])
    assert emu.flip_bit("linear_head", "w", 0, 31) == expected
    # word index wraps modulo the flat size (a plan can't miss the array);
    # XOR involution: the wrapped flip lands on word 0 and restores it
    assert emu.flip_bit("linear_head", "w", flat.size, 31) == int(flat[0])
    with pytest.raises(KeyError):
        emu.flip_bit("linear_head", "nope", 0, 0)
    with pytest.raises(ValueError):
        emu.flip_bit("linear_head", "w", 0, 32)


def test_flip_bit_invalidates_compiled_programs(lstm_graph, lstm_vectors):
    """A flip after a dispatch must still corrupt the next dispatch, and
    the programs are dropped, as the reference drops its jitted ones."""
    dep = _rtl_dep(lstm_graph)
    stim = lstm_vectors.stimulus
    first = dep.emulator.run_int(stim).outputs.numpy()
    assert dep.emulator.cache_stats()["misses"] == 1
    dep.emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
    second = dep.emulator.run_int(stim).outputs.numpy()
    assert not np.array_equal(first, second)
    assert dep.emulator.cache_stats()["misses"] == 2   # re-traced


@pytest.mark.parametrize("arch", ARCHS)
def test_memories_equal_the_reference(arch):
    tg, jg = tvec.canonical_graph(arch)[0], jvec.canonical_graph(arch)[0]
    got = RTLEmulator(tg, device=CPU).memories()
    assert got == JRTLEmulator(jg).memories()
    assert all(isinstance(m, tuple) and len(m) == 2 for m in got)


def _memory_cases():
    return [(arch, node, key) for arch in ARCHS
            for node, key in RTLEmulator(tvec.canonical_graph(arch)[0],
                                         device=CPU).memories()]


@pytest.mark.parametrize("arch,node,key", _memory_cases())
def test_every_bit_of_every_memory_flips_as_in_the_reference(arch, node,
                                                             key):
    """Bits 0-31 of one seeded word: the new word equals the reference's,
    and the emulator's codes after each flip (its fused walk, the plain
    versions here) equal the reference emulator's flipped the same way;
    the second flip of each bit restores the word and the codes. The
    reference's side runs its compiled walk of the unflipped design on its
    flipped memories (its memories are the walk's operands), which is what
    its ``run_int`` compiles again after each flip."""
    tg, jg = tvec.canonical_graph(arch)[0], jvec.canonical_graph(arch)[0]
    te, je = RTLEmulator(tg, device=CPU), JRTLEmulator(jg)
    x = tvec.generate_vectors(tg, device=CPU).stimulus
    base = te.run_int(x).outputs.numpy()
    jwalk = je._program(x.shape, x.dtype)[0]
    out = jg.outputs[0]
    size = te.prepared(node)[key].numel()
    word = int(np.random.default_rng(size).integers(size))
    mismatches = 0
    for bit in range(32):
        new = te.flip_bit(node, key, word, bit)
        assert new == je.flip_bit(node, key, word, bit), bit
        got = te.run_int(x).outputs.numpy()
        mismatches += int(np.count_nonzero(
            got != np.asarray(jwalk(x, je.params())[out])))
        te.flip_bit(node, key, word, bit)
        je.flip_bit(node, key, word, bit)
    assert mismatches == 0
    assert np.array_equal(te.run_int(x).outputs.numpy(), base)
    assert te.seu_flips == je.seu_flips == 64


# --------------------------------------------------------------------------- #
# B1's variant follows the W it is handed (a flipped bit 7 leaves w_fmt)
# --------------------------------------------------------------------------- #


def test_b1_variant_goes_simt_for_a_flipped_w_and_back(lstm_graph):
    """Table I's cell with W word 0 set to ``w0 ^ 128``: outside Q8.6's
    codes, so ``simt``; the second flip restores the word and ``mma``."""
    em = RTLEmulator(lstm_graph, device=CPU)
    spec = em.prepared("lstm_cell_l0")["spec"]
    w = em.prepared("lstm_cell_l0")["w"]
    w0 = int(w.view(-1)[0])
    assert b1_ops.variant(spec) == b1_ops.variant(spec, w) == "mma"
    assert em._b1_variants == ("mma",)
    assert em.flip_bit("lstm_cell_l0", "w", 0, 7) == w0 ^ 128
    assert not b1_kernel.check_w_codes(w, spec)
    assert b1_ops.variant(spec, w) == "simt"
    assert b1_ops.variant(spec) == "mma"         # the spec alone
    assert em._b1_variants == ("simt",)
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    assert int(w.view(-1)[0]) == w0 and b1_ops.variant(spec, w) == "mma"
    assert em._b1_variants == ("mma",)
    # a flip elsewhere keeps mma: the bias and the ROMs never reach an
    # int8 operand (the bias is added after the product, h is re-clipped)
    for node, key in (("lstm_cell_l0", "b"), ("hard_sigmoid_lut", "table")):
        em.flip_bit(node, key, 0, 30)
        assert em._b1_variants == ("mma",)
        em.flip_bit(node, key, 0, 30)


def test_b1_wrapper_routes_a_w_written_in_place():
    """The routing reads W's range once per version: a write in place is
    seen by the next call; on the CPU the wrapper runs the plain version
    (no launch is counted) whatever the route."""
    rng = np.random.default_rng(3)
    A, W, C = FxpFormat(8, 4), FxpFormat(8, 6), FxpFormat(16, 8)
    spec = b1_kernel.CellSpec(seq_len=6, d_in=1, hidden=20, act_fmt=A,
                              state_fmt=C, w_fmt=W, sig_lo=A.lo,
                              tanh_lo=A.lo)
    w = torch.from_numpy(rng.integers(W.lo, W.hi + 1, (21, 80))
                         .astype(np.int32))
    assert b1_ops.variant(spec, w) == "mma"
    w[3, 7] = W.hi + 1
    assert b1_ops.variant(spec, w) == "simt"
    w[3, 7] = W.lo - 1
    assert b1_ops.variant(spec, w) == "simt"
    w[3, 7] = 0
    assert b1_ops.variant(spec, w) == "mma"


def test_isomorphic_siblings_with_one_flipped_stay_bit_exact():
    """Siblings share one ProgramLRU. After a flip that sends B's cell to
    ``simt``, A (``mma``) and B no longer share a program: the port builds
    one where the reference's shared cache hits (the one divergence), and
    both answers stay equal to the reference's integer for integer."""
    tgs = [tvec.canonical_graph("elastic-lstm", seed=s)[0] for s in (0, 1)]
    jgs = [jvec.canonical_graph("elastic-lstm", seed=s)[0] for s in (0, 1)]
    lru = ProgramLRU(4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.rtl.program_cache import ProgramLRU as JProgramLRU
    jlru = JProgramLRU(4)
    tems = [RTLEmulator(g, programs=lru, device=CPU) for g in tgs]
    jems = [JRTLEmulator(g, programs=jlru) for g in jgs]
    x = np.random.default_rng(9).integers(-128, 128, (33, 6, 1)).astype(
        np.int32)
    for t, j in zip(tems, jems):
        assert np.array_equal(t.run_int(x).outputs.numpy(),
                              np.asarray(j.run_int(x).outputs))
    assert lru.stats()["misses"] == jlru.stats()["misses"] == 1
    tems[1].flip_bit("lstm_cell_l0", "w", 0, 7)
    jems[1].flip_bit("lstm_cell_l0", "w", 0, 7)
    assert [em._b1_variants for em in tems] == [("mma",), ("simt",)]
    for _ in range(2):
        for t, j in zip(tems, jems):
            assert np.array_equal(t.run_int(x).outputs.numpy(),
                                  np.asarray(j.run_int(x).outputs))
    # after the flip's clear: A builds, B builds (the reference hits)
    assert lru.stats()["misses"] == 3 and jlru.stats()["misses"] == 2
    # restoring B's word brings the two back onto one program
    tems[1].flip_bit("lstm_cell_l0", "w", 0, 7)
    for t in tems:
        t.run_int(x)
    assert lru.stats()["misses"] == 4 and len(lru) == 1


def test_flips_under_concurrent_runs_never_mix_a_run(lstm_graph):
    """Worker threads run one emulator while another thread flips a W bit
    back and forth: each answer is the unflipped or the flipped design's,
    never a mix, and nothing raises (the emulator's lock covers a run from
    its program key to its result, and flip_bit's write and clear)."""
    import sys
    import threading

    em = RTLEmulator(lstm_graph, device=CPU)
    x = np.random.default_rng(2).integers(-128, 128, (64, 6, 1)).astype(
        np.int32)
    want = [em.run_int(x).outputs.numpy()]
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    want.append(em.run_int(x).outputs.numpy())
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    assert not np.array_equal(*want)
    bad, errors, stop = [], [], threading.Event()

    def run():
        try:
            while not stop.is_set():
                got = em.run_int(x).outputs.numpy()
                if not any(np.array_equal(got, w) for w in want):
                    bad.append(got)
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    def flip():
        try:
            for _ in range(40):
                em.flip_bit("lstm_cell_l0", "w", 0, 7)
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runners = [threading.Thread(target=run) for _ in range(6)]
        flipper = threading.Thread(target=flip)
        for t in runners + [flipper]:
            t.start()
        flipper.join(timeout=60)
        stop.set()
        for t in runners:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not flipper.is_alive() and not any(t.is_alive() for t in runners)
    assert errors == [] and bad == []
    assert em.seu_flips == 42
    assert np.array_equal(em.run_int(x).outputs.numpy(), want[0])


# --------------------------------------------------------------------------- #
# FaultyDeployment
# --------------------------------------------------------------------------- #


class _EchoDeployment(Deployment):
    target = "echo"

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return torch.as_tensor(x)


def test_faulty_transient_and_once(lstm_vectors):
    inner = _EchoDeployment()
    plan = FaultPlan(faults=(FaultSpec(kind="transient", at_call=1),))
    fd = FaultyDeployment(inner, plan)
    x = np.ones((1, 2), np.float32)
    fd(x)
    with pytest.raises(TransientFault):
        fd(x)
    fd(x)                                        # once=True: disarmed
    assert [f["kind"] for f in fd.injected] == ["transient"]


def test_faulty_stuck_output_and_latency():
    inner = _EchoDeployment()
    clk = VirtualClock()
    mx = MetricsRegistry()
    plan = FaultPlan(faults=(
        FaultSpec(kind="stuck_output", at_call=0, value=3.0),
        FaultSpec(kind="latency", at_call=1, delay_s=0.75)))
    fd = FaultyDeployment(inner, plan, clock=clk, metrics=mx)
    out = fd(np.zeros((2, 2), np.float32))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert torch.all(out == 3.0)                 # wedged output register
    fd(np.zeros((2, 2), np.float32))
    assert clk.now() == 0.75                     # stall on the virtual clock
    assert mx.counter("resilience.faults_injected").value == 2
    assert mx.counter("resilience.faults_injected.latency").value == 1


def test_stuck_output_keeps_the_tree_and_its_leaves_kinds():
    class _Tree(Deployment):
        target = "tree"

        def __call__(self, x):
            return {"y": torch.ones(2, dtype=torch.int32),
                    "z": (np.zeros(3, np.float32), 1.5)}

    plan = FaultPlan(faults=(FaultSpec(kind="stuck_output", at_call=0,
                                       value=-2.0),))
    out = FaultyDeployment(_Tree(), plan)(None)
    assert out["y"].dtype == torch.int32 and torch.all(out["y"] == -2)
    assert isinstance(out["z"][0], np.ndarray) and np.all(out["z"][0] == -2)
    assert float(out["z"][1]) == -2.0


def test_faulty_bitflip_needs_rtl():
    plan = FaultPlan(faults=(FaultSpec(kind="bitflip", at_call=0),))
    fd = FaultyDeployment(_EchoDeployment(), plan)
    with pytest.raises(ValueError, match="no RTL emulator"):
        fd(np.zeros((1, 1), np.float32))


def test_faulty_bitflip_unknown_memory(lstm_graph):
    plan = FaultPlan(faults=(FaultSpec(kind="bitflip", at_call=0,
                                       memory="nope.w"),))
    fd = FaultyDeployment(_rtl_dep(lstm_graph), plan)
    with pytest.raises(ValueError, match="addressable memories"):
        fd(np.zeros((1, 2), np.float32))


def test_faulty_probabilistic_schedule_is_seeded():
    spec = FaultSpec(kind="transient", probability=0.3, once=False)

    def fire_pattern():
        fd = FaultyDeployment(_EchoDeployment(),
                              FaultPlan(faults=(spec,), seed=11))
        fired = []
        for _ in range(32):
            try:
                fd(np.zeros((1, 1), np.float32))
                fired.append(0)
            except TransientFault:
                fired.append(1)
        return fired

    a, b = fire_pattern(), fire_pattern()
    assert a == b and 0 < sum(a) < 32            # deterministic, non-trivial


def test_seeded_bitflips_draw_the_reference_faults(lstm_graph):
    """Memory, word and probabilistic triggers come from one numpy PCG64
    stream keyed by the plan's seed: the port and the reference inject the
    same faults at the same calls and leave the same words."""
    jg = jvec.canonical_graph("elastic-lstm")[0]
    kw = dict(kind="bitflip", probability=0.4, once=False, bit=5)
    tdep, jdep = _rtl_dep(lstm_graph), _j_rtl_dep(jg)
    td = FaultyDeployment(tdep, FaultPlan(faults=(FaultSpec(**kw),),
                                          seed=21))
    jd = __import__("repro.resilience", fromlist=["x"]).FaultyDeployment(
        jdep, JFaultPlan(faults=(JFaultSpec(**kw),), seed=21))
    x = np.zeros((2, 6, 1), np.float32)
    for _ in range(12):
        np.testing.assert_array_equal(td(x).numpy(), np.asarray(jd(x)))
    assert td.injected == jd.injected and len(td.injected) > 2


# --------------------------------------------------------------------------- #
# CircuitBreaker
# --------------------------------------------------------------------------- #


def test_breaker_state_machine():
    clk = VirtualClock()
    mx = MetricsRegistry()
    pol = GuardPolicy(breaker_threshold=2, breaker_cooldown_s=1.0)
    b = CircuitBreaker(pol, clock=clk, metrics=mx)
    assert b.state == CLOSED and b.allow()
    b.record_failure()
    assert b.state == CLOSED                     # under threshold
    b.record_failure()
    assert b.state == OPEN and b.trips == 1
    assert not b.allow()                         # cooling down
    clk.advance(1.0)
    assert b.allow() and b.state == HALF_OPEN    # probe admitted
    b.record_failure()
    assert b.state == OPEN and b.trips == 2      # failed probe re-opens
    clk.advance(1.0)
    assert b.allow()
    b.record_success()
    assert b.state == CLOSED and b.failures == 0
    assert mx.counter("resilience.breaker.open").value == 2
    assert mx.counter("resilience.breaker.closed").value == 1


def test_breaker_quarantine_never_half_opens():
    clk = VirtualClock()
    b = CircuitBreaker(GuardPolicy(breaker_cooldown_s=0.1), clock=clk)
    b.trip(quarantine=True)
    clk.advance(100.0)
    assert not b.allow() and b.quarantined       # corrupted HW can't heal
    b.reset()                                    # operator reflash
    assert b.state == CLOSED and b.allow() and not b.quarantined


# --------------------------------------------------------------------------- #
# GuardedDeployment
# --------------------------------------------------------------------------- #


class _FlakyDeployment(Deployment):
    """Fails the first ``n_fail`` calls, then succeeds."""

    target = "flaky"

    def __init__(self, n_fail):
        self.n_fail = n_fail
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        if self.calls <= self.n_fail:
            raise RuntimeError("flaked")
        return torch.as_tensor(x) + 1


def test_guard_retry_heals_transient():
    clk = VirtualClock()
    mx = MetricsRegistry()
    g = GuardedDeployment(_FlakyDeployment(2),
                          policy=GuardPolicy(max_retries=2,
                                             breaker_threshold=5),
                          clock=clk, rng=np.random.default_rng(0),
                          metrics=mx)
    res = g.call(np.zeros((1,), np.float32))
    assert res.retries == 2 and res.source == "primary"
    assert not res.degraded
    assert mx.counter("resilience.retries").value == 2
    assert g.breaker.state == CLOSED             # success reset the count
    # backoff slept on the injected clock: base*(1±j) + base*mult*(1±j)
    pol = g.policy
    lo = (pol.backoff_base_s * (1 - pol.jitter_frac)
          * (1 + pol.backoff_mult))
    hi = (pol.backoff_base_s * (1 + pol.jitter_frac)
          * (1 + pol.backoff_mult))
    assert lo <= clk.now() <= hi


def test_guard_backoff_jitter_is_deterministic():
    def elapsed():
        clk = VirtualClock()
        g = GuardedDeployment(_FlakyDeployment(2),
                              policy=GuardPolicy(max_retries=2,
                                                 breaker_threshold=5),
                              clock=clk, rng=np.random.default_rng(42),
                              metrics=MetricsRegistry())
        g.call(np.zeros((1,), np.float32))
        return clk.now()

    assert elapsed() == elapsed()                # same rng -> same jitter
    jclk = JVirtualClock()
    JGuardedDeployment(_FlakyDeployment(2), policy=JGuardPolicy(
        max_retries=2, breaker_threshold=5), clock=jclk,
        rng=np.random.default_rng(42),
        metrics=jobs.MetricsRegistry()).call(np.zeros((1,), np.float32))
    assert elapsed() == jclk.now()               # the reference's jitter


def test_guard_timeout_counts_as_failure(lstm_graph, lstm_vectors):
    """A latency fault longer than timeout_s fails the attempt even though
    the call returns — the retry (clean: once=True disarmed it) serves."""
    clk = VirtualClock()
    mx = MetricsRegistry()
    plan = FaultPlan(faults=(FaultSpec(kind="latency", at_call=0,
                                       delay_s=1.0),))
    faulty = FaultyDeployment(_rtl_dep(lstm_graph), plan, clock=clk,
                              metrics=mx)
    g = GuardedDeployment(faulty,
                          policy=GuardPolicy(timeout_s=0.5, max_retries=1,
                                             breaker_threshold=5),
                          clock=clk, rng=np.random.default_rng(0),
                          metrics=mx)
    res = g.call(lstm_vectors.stimulus_f()[:1])
    assert res.retries == 1 and res.source == "primary"
    assert mx.counter("resilience.timeouts").value == 1


def test_guard_canary_detects_seu_and_quarantines(lstm_graph, lstm_vectors):
    clk = VirtualClock()
    mx = MetricsRegistry()
    dep = _rtl_dep(lstm_graph)
    g = GuardedDeployment(dep, policy=GuardPolicy(canary_every=2),
                          canary=lstm_vectors, clock=clk,
                          rng=np.random.default_rng(0), metrics=mx)
    x = lstm_vectors.stimulus_f()[:1]
    assert g.call(x).canary_passed is True       # healthy probe at call 0
    dep.emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
    g.call(x)                                    # call 1: no probe due
    with pytest.raises(GuardExhausted):          # call 2: probe detects
        g.call(x)
    assert g.breaker.quarantined
    assert len(g.detections) == 1
    assert mx.counter("resilience.faults_detected").value == 1
    assert mx.counter("resilience.requests_lost").value == 1
    assert not g.can_serve()                     # no fallback -> drained


def test_guard_fallback_chain_order():
    clk = VirtualClock()
    mx = MetricsRegistry()

    def bad(x):
        raise RuntimeError("alternate down too")

    calls = []

    def good(x):
        calls.append(x)
        return "served"

    g = GuardedDeployment(
        _FlakyDeployment(10),                    # primary never succeeds
        policy=GuardPolicy(max_retries=0, breaker_threshold=1),
        fallback=FallbackPolicy(alternates=(("first", bad),
                                            ("second", good))),
        clock=clk, rng=np.random.default_rng(0), metrics=mx)
    res = g.call("x")
    assert res.source == "second" and res.degraded and res.value == "served"
    assert mx.counter("resilience.fallback_errors").value == 1
    assert mx.counter("resilience.fallbacks").value == 1
    assert g.can_serve()                         # fallback keeps it serving


def test_guard_call_dunder_returns_value():
    g = GuardedDeployment(_FlakyDeployment(0),
                          policy=GuardPolicy(breaker_threshold=5),
                          clock=VirtualClock(),
                          rng=np.random.default_rng(0),
                          metrics=MetricsRegistry())
    out = g(np.zeros((2,), np.float32))
    assert torch.all(out == 1.0)                 # Deployment contract


def test_deployment_guarded_hook(lstm_graph, lstm_vectors):
    """Deployment.guarded() wraps any registry-produced artifact."""
    dep = _rtl_dep(lstm_graph)
    g = dep.guarded(canary=lstm_vectors, clock=VirtualClock(),
                    rng=np.random.default_rng(0), metrics=MetricsRegistry())
    assert isinstance(g, GuardedDeployment)
    assert g.target == "rtl" and g.graph is lstm_graph
    assert g.probe() is True
    fb = FallbackPolicy.to_xla(_xla_fallback(lstm_graph))
    assert fb.alternates[0][0] == "xla" and bool(fb)


def test_guard_wall_clock_timeout_reads_a_synchronised_answer():
    """With a wall clock, the attempt's time includes the answer's work:
    the guard waits for the devices of every tensor in the answer (none
    here, on the CPU) before it reads the clock."""
    ticks = iter(range(100))

    class _Tree(Deployment):
        target = "tree"

        def __call__(self, x):
            return {"a": torch.zeros(1), "b": [np.zeros(1), None]}

    g = GuardedDeployment(_Tree(), policy=GuardPolicy(timeout_s=0.5),
                          clock=lambda: float(next(ticks)),
                          sleep=lambda s: None,
                          metrics=MetricsRegistry())
    with pytest.raises(GuardExhausted):          # each attempt takes 1 s
        g.call(None)
    assert g.metrics.counter("resilience.timeouts").value == 3


# --------------------------------------------------------------------------- #
# Canary slice API
# --------------------------------------------------------------------------- #


def test_vectorset_head_slice(lstm_vectors):
    h = lstm_vectors.head(4)
    assert h.n_vectors == 4
    assert np.array_equal(h.stimulus, lstm_vectors.stimulus[:4])
    assert np.array_equal(h.response, lstm_vectors.response[:4])
    assert h.meta["slice"] == "head(4)"
    assert lstm_vectors.head(10_000).n_vectors == lstm_vectors.n_vectors
    with pytest.raises(ValueError):
        lstm_vectors.head(0)


def test_canary_check_float_path(lstm_graph, lstm_vectors):
    """Host-executed deployments answer in float; the canary re-encodes at
    the output format and still demands integer-exact codes."""
    fb = _xla_fallback(lstm_graph)
    res = canary_check(fb, lstm_vectors, n=4)
    assert res.passed and res.path == "float"


# --------------------------------------------------------------------------- #
# The acceptance scenario + determinism audit
# --------------------------------------------------------------------------- #


def _acceptance_spec(pkg=None):
    spec, plan, policy = (ChaosSpec, FaultPlan, GuardPolicy) if pkg is None \
        else pkg
    return spec(plan=plan.load(PLAN_PATH), n_requests=24, seed=7,
                policy=policy(timeout_s=0.25, max_retries=2,
                              breaker_threshold=3, canary_every=4))


def test_chaos_scenario_elastic_lstm(lstm_graph):
    """Injected BRAM bit-flip -> canary detection within one probe
    interval -> breaker quarantine -> RTL→host failover with zero
    post-detection corrupted responses, all recorded in the report and the
    resilience.* counters."""
    dep = _rtl_dep(lstm_graph)
    rep = run_chaos(dep, _acceptance_spec(),
                    fallback=FallbackPolicy.to_xla(_xla_fallback(lstm_graph)))
    assert rep.passed and rep.detected and rep.recovered
    assert rep.corrupted_after_detection == 0
    assert rep.requests_lost == 0                # the workload kept serving
    assert 0 <= rep.mttr_requests <= 4           # within one probe interval
    assert rep.final_breaker_state == OPEN and rep.breaker_trips == 1
    assert rep.counters["resilience.faults_injected"] == 3
    assert rep.counters["resilience.faults_detected"] == 1
    assert rep.counters["resilience.fallbacks"] > 0
    assert rep.counters["resilience.retries"] > 0
    kinds = [f["kind"] for f in rep.faults_injected]
    assert kinds == ["transient", "latency", "bitflip"]
    # post-detection requests all served degraded by the host alternate
    det = rep.faults_detected[0]["request"]
    post = [r for r in rep.requests if r["request"] > det]
    assert post and all(r["source"] == "xla" and r["correct"]
                        for r in post)


def test_chaos_run_twice_identical(lstm_graph):
    """Determinism audit: every retry/jitter/fault path draws from injected
    generators and the shared VirtualClock, so the full report JSON is
    byte-identical across runs (the emit-twice golden-artifact pattern)."""
    fb = FallbackPolicy.to_xla(_xla_fallback(lstm_graph))
    r1 = run_chaos(_rtl_dep(lstm_graph), _acceptance_spec(), fallback=fb)
    r2 = run_chaos(_rtl_dep(lstm_graph), _acceptance_spec(), fallback=fb)
    assert r1.to_json() == r2.to_json()


def test_chaos_needs_graph_or_vectors():
    with pytest.raises(ValueError, match="vectors"):
        run_chaos(_EchoDeployment(),
                  ChaosSpec(plan=FaultPlan(
                      faults=(FaultSpec(kind="transient", at_call=0),))))


def _workflow_spec(pkg):
    spec, plan, fault, policy = pkg
    return spec(plan=plan(faults=(
        fault(kind="bitflip", at_call=3, memory="lstm_cell_l0.w", word=0,
              bit=7),), seed=3), n_requests=10,
        policy=policy(max_retries=1, breaker_threshold=3, canary_every=2))


T_PKG = (ChaosSpec, FaultPlan, FaultSpec, GuardPolicy)
J_PKG = (JChaosSpec, JFaultPlan, JFaultSpec, JGuardPolicy)


def _workflow_test_params():
    """The reference workflow test's params (``init_params`` at
    ``PRNGKey(0)``), carried across by ``convert.params_from_jax``."""
    cfg = j_get_config("elastic-lstm")
    jp = j_init_params(j_lstm_schema(cfg), jax.random.PRNGKey(0))
    return jp, to_torch(params_from_jax(jp, get_config("elastic-lstm")),
                        CPU)


def _report_pair(case):
    """(port report, reference report) of one chaos case, each on its
    package's graph of the same params."""
    if case == "acceptance":
        tg = tvec.canonical_graph("elastic-lstm")[0]
        jg = jvec.canonical_graph("elastic-lstm")[0]
        tspec, jspec = _acceptance_spec(), _acceptance_spec(
            (JChaosSpec, JFaultPlan, JGuardPolicy))
    else:
        if case == "workflow-numpy-params":
            tp = tvec.canonical_params(
                tvec.schema_for(get_config("elastic-lstm")), seed=11)
            jp = jvec.canonical_params(
                j_lstm_schema(j_get_config("elastic-lstm")), seed=11)
        else:
            jp, tp = _workflow_test_params()
        tg = tir.lower_model(get_config("elastic-lstm"), tp)
        jg = jir.lower_model(j_get_config("elastic-lstm"), jp)
        tspec, jspec = _workflow_spec(T_PKG), _workflow_spec(J_PKG)
    tdep = _rtl_dep(tg)
    trep = run_chaos(tdep, tspec, fallback=chaos_fallback(tdep, XC7S15))
    jrep = j_run_chaos(_j_rtl_dep(jg), jspec, fallback=JFallbackPolicy
                       .to_xla(_j_xla_fallback(jg)))
    return trep, jrep


@pytest.mark.parametrize("case,passed", [
    ("acceptance", True), ("workflow-numpy-params", True),
    ("workflow-test-params", False)])
def test_report_json_equals_the_reference(case, passed):
    """Byte-equal ``to_json()``. The workflow test's scenario on that
    test's own params injects its flip on a word whose corruption the
    canary's rail rows never see: the reference reports FAIL (its
    ``test_workflow_resilience_stage_records_report`` fails on it), and so
    does the port."""
    trep, jrep = _report_pair(case)
    assert trep.to_json() == jrep.to_json()
    assert trep.passed is passed
    assert trep.summary() == jrep.summary()


# --------------------------------------------------------------------------- #
# Workflow(resilience=...) and the launcher's --chaos
# --------------------------------------------------------------------------- #


def _workflows(spec_t, spec_j):
    """Both packages' Workflow on the RTL target with the reference
    workflow test's fixed train_fn (its params) and step builder."""
    jp, tp = _workflow_test_params()
    cfg, jcfg = get_config("elastic-lstm"), j_get_config("elastic-lstm")
    x = np.zeros((1, cfg.lstm.seq_len, cfg.lstm.in_features), np.float32)

    def steps(params):
        return lambda knobs, p: (lambda pp, xx: xx, (p, x), 1.0)

    cr = Creator(hw=XC7S15, device=CPU)
    twf = Workflow(
        creator=cr, train_fn=lambda k: (tp, DesignReport(
            model="elastic-lstm", train_loss=0.0, eval_loss=0.0), None),
        step_builder=steps(tp), stepper_builder=lambda k: cr.build(
            cfg, SHAPES_LSTM["infer_1"]), target="rtl", resilience=spec_t)
    jcr = JCreator(hw=J_XC7S15)
    jwf = jworkflow.Workflow(
        creator=jcr, train_fn=lambda k: (jp, JDesignReport(
            model="elastic-lstm", train_loss=0.0, eval_loss=0.0), None),
        step_builder=steps(jp), stepper_builder=lambda k: jcr.build(
            jcfg, J_SHAPES_LSTM["infer_1"]), target="rtl",
        resilience=spec_j)
    return twf, jwf


def test_workflow_resilience_stage_records_report():
    """Workflow(resilience=ChaosSpec).run_once drives the scenario against
    the deployed RTL artifact and attaches the ResilienceReport under a
    ``workflow.resilience`` span. On the reference workflow test's params
    both packages report the same scenario byte for byte: FAIL (the canary
    never sees this flip), as the reference's own test finds."""
    twf, jwf = _workflows(_workflow_spec(T_PKG), _workflow_spec(J_PKG))
    with tobs.capture("wf") as cap:
        rec = twf.run_once({"bits": 8, "frac": 6})
    with jobs.capture("wf"):
        jrec = jwf.run_once({"bits": 8, "frac": 6})
    resil = rec.resilience
    assert resil is not None
    assert resil.to_json() == jrec.resilience.to_json()
    assert resil.counters["resilience.faults_injected.bitflip"] == 1
    assert not resil.passed and not resil.detected
    sr = tobs.find_spans(cap.trace.spans, "workflow.resilience")[0]
    assert sr.attrs == {"passed": False, "detected": False, "degraded": 0,
                        "lost": 0}
    assert tobs.find_spans(cap.trace.spans, "resilience.chaos")
    (root,) = tobs.find_spans(cap.trace.spans, "workflow.run_once")
    assert sr.parent_id == root.span_id
    assert rec.measurement.target == "rtl"


def test_workflow_resilience_needs_graph_target():
    """The chaos stage needs a graph-carrying deployment (golden vectors +
    same-design host fallback); host-executed targets fail loudly."""
    spec = ChaosSpec(plan=FaultPlan(
        faults=(FaultSpec(kind="transient", at_call=0),)), n_requests=2)
    x = torch.zeros(2)
    wf = Workflow(creator=Creator(device=CPU),
                  train_fn=lambda k: (None, DesignReport(
                      model="m", train_loss=0.0, eval_loss=0.0), None),
                  step_builder=lambda k, p: (lambda xx: xx * 2, (x,), 4.0),
                  target="xla", resilience=spec)
    with pytest.raises(ValueError, match="graph-carrying"):
        wf.run_once({"bits": 8, "frac": 6})


LAUNCH = ("--target", "rtl", "--device", CPU, "--train-steps", "2",
          "--max-iters", "1")


def test_launcher_chaos_writes_the_report_of_its_final_design(
        tmp_path, monkeypatch, capsys):
    """``--chaos examples/chaos_plan.json`` writes ``resilience.json``:
    equal to ``run_chaos`` called directly on the launcher's final design
    (a fresh copy: the run flipped the first one's memory) and identical
    across two runs. The launcher exits non-zero exactly when the report
    fails: at two training steps the final design is Q4.2, whose flipped
    word moves no golden answer, so nothing is detected."""
    finals = []
    stage = tew.run_chaos_stage

    def spy(dep, plan_path):
        finals.append(dataclasses.replace(dep))
        return stage(dep, plan_path)

    monkeypatch.setattr(tew, "run_chaos_stage", spy)
    texts, exits = [], []
    for run in ("a", "b"):
        out = tmp_path / run
        try:
            exits.append(tew.main([*LAUNCH, "--chaos", PLAN_PATH,
                                   "--build-dir", str(out)]))
        except SystemExit as e:
            exits.append(str(e))
        texts.append((out / "elastic-lstm" / "resilience.json").read_text())
    assert texts[0] == texts[1] and exits[0] == exits[1]
    direct = run_chaos(finals[0], tew.chaos_spec(PLAN_PATH),
                       fallback=chaos_fallback(finals[0], XC7S15))
    assert texts[0] == direct.to_json() + "\n"
    report = json.loads(texts[0])
    assert report["faults_injected"][2]["memory"] == "lstm_cell_l0.w"
    if report["passed"]:
        assert exits[0] == 0
    else:
        assert exits[0].startswith("chaos scenario FAILED: detected=")
    assert direct.summary() in capsys.readouterr().out


def test_launcher_chaos_needs_the_rtl_target(capsys):
    with pytest.raises(SystemExit):
        tew.main(["--device", CPU, "--chaos", PLAN_PATH])
    assert "use --target rtl" in capsys.readouterr().err


def test_launcher_trace_writes_the_run_trace_bundle(tmp_path):
    """``--trace`` captures the run (spans and metrics) and writes the
    RunTrace bundle beside the trace, a copy in the --build-dir bundle."""
    trace = tmp_path / "t" / "run.json"
    trace.parent.mkdir()
    assert tew.main([*LAUNCH, "--trace", str(trace), "--build-dir",
                     str(tmp_path / "b")]) == 0
    for d in (trace.parent, tmp_path / "b" / "elastic-lstm"):
        for name in ("trace.json", "trace.jsonl", "metrics.json",
                     "summary.txt"):
            assert (d / name).is_file(), (d, name)
    spans = tobs.from_chrome_trace(json.loads(trace.read_text()))
    assert tobs.find_spans(spans, "workflow.run_once")
    metrics = json.loads((trace.parent / "metrics.json").read_text())
    assert metrics["rtl.emulator.dispatch.fused"]["value"] > 0
    assert not tobs.get_tracer().enabled         # the capture was closed


# --------------------------------------------------------------------------- #
# Guarded members in the farm and the DeploymentPool
# --------------------------------------------------------------------------- #


def _guarded(pkg, exe, vectors, clock, mx, name):
    guard_cls, policy = pkg
    return guard_cls(exe, policy=policy(canary_every=2, max_retries=0),
                     canary=vectors, clock=clock,
                     rng=np.random.default_rng(0), metrics=mx, name=name)


def _farm_script(serving, pkg, exe, vectors, clock, mx):
    """Two guarded replicas of one design; replica 0 (which the router's
    affinity keeps busy) takes a flipped W bit mid-pass. Returns each
    request's (status, member, result), the stats, the guards' health."""
    members = [_guarded(pkg, dataclasses.replace(exe), vectors, clock, mx,
                        f"r{i}") for i in range(2)]
    pool = serving.DesignPool(family="lstm", members={6: members})
    farm = serving.AcceleratorFarm([pool], serving.FarmConfig(max_batch=4),
                                   clock=clock, metrics=mx)
    rng = np.random.default_rng(8)
    rids = []
    for wave in range(6):
        rids += [farm.submit("lstm", rng.standard_normal(
            (int(t), 1)).astype(np.float32) * 0.5)
            for t in rng.integers(1, 7, size=4)]
        if wave == 2:
            members[0].emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
        farm.tick(flush=True)
    stats = farm.run_until_drained().to_dict()
    reqs = [farm.result(r) for r in rids]
    return ([(r.status, r.member, np.asarray(r.result).tolist())
             for r in reqs], stats, [m.health() for m in members],
            [m.detections for m in members])


def test_guarded_farm_equals_the_reference_with_one_member_flipped():
    tg, jg = (tvec.canonical_graph("elastic-lstm")[0],
              jvec.canonical_graph("elastic-lstm")[0])
    got = _farm_script(__import__("repro_torch.serving", fromlist=["*"]),
                       (GuardedDeployment, GuardPolicy), _rtl_dep(tg),
                       generate_vectors(tg, device=CPU), VirtualClock(),
                       MetricsRegistry())
    want = _farm_script(jserving, (JGuardedDeployment, JGuardPolicy),
                        _j_rtl_dep(jg), jvec.generate_vectors(jg),
                        JVirtualClock(), jobs.MetricsRegistry())
    assert got == want
    states, stats, health, detections = got
    assert health[0]["quarantined"] and not health[1]["quarantined"]
    assert len(detections[0]) == 1 and detections[1] == []
    assert stats["failed"] == 0 and stats["redispatches"] >= 1
    assert stats["admitted"] == stats["done"] + stats["expired"]
    # once quarantined, replica 0 takes nothing: the requests after the
    # detecting call all went to replica 1
    detected_at = detections[0][0]["call"]
    assert health[0]["calls"] == detected_at
    assert all(s[0] == "done" for s in states)


def _pool_script(pool_cls, pkg, exe, vectors, clock, mx, x):
    members = [_guarded(pkg, dataclasses.replace(exe), vectors, clock, mx,
                        f"m{i}") for i in range(2)]
    pool = pool_cls(members, max_queue=8, metrics=mx)
    rids = []
    for step in range(6):
        rids += [pool.submit(x[i % len(x)][None]) for i in range(2)]
        if step == 1:
            members[1].emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
        pool.tick()
    stats = pool.drain()
    out = []
    for r in rids:
        res = dict(pool.result(r))
        if "value" in res:
            v = res["value"]
            res["value"] = (v.numpy() if isinstance(v, torch.Tensor)
                            else np.asarray(v)).tolist()
        out.append(res)
    return out, dataclasses.asdict(stats), [m.health() for m in members]


def test_guarded_deployment_pool_equals_the_reference_with_one_flipped():
    tg, jg = (tvec.canonical_graph("elastic-lstm")[0],
              jvec.canonical_graph("elastic-lstm")[0])
    tv, jv = generate_vectors(tg, device=CPU), jvec.generate_vectors(jg)
    x = tv.stimulus_f()
    got = _pool_script(DeploymentPool, (GuardedDeployment, GuardPolicy),
                       _rtl_dep(tg), tv, VirtualClock(), MetricsRegistry(),
                       x)
    want = _pool_script(jserving.DeploymentPool,
                        (JGuardedDeployment, JGuardPolicy), _j_rtl_dep(jg),
                        jv, JVirtualClock(), jobs.MetricsRegistry(), x)
    assert got == want
    results, stats, health = got
    assert health[1]["quarantined"] and health[1]["detections"] == 1
    assert stats["lost"] == 1                    # the detecting call's own
    lost = [r["rid"] for r in results if r["status"] == "lost"]
    # after the detection only member 0 serves
    assert all(r["member"] == 0 for r in results
               if r.get("rid", -1) > lost[0] and "member" in r)


# --------------------------------------------------------------------------- #
# RunTrace / capture and FailureInjector
# --------------------------------------------------------------------------- #


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _trace_script(obs, tmp):
    with obs.capture("run", clock=_FakeClock()) as cap:
        with obs.span("outer", design="elastic-lstm", k=3):
            with obs.span("inner", mode="fused"):
                obs.get_metrics().counter("rtl.emulator.seu_flips").inc(2)
            obs.get_metrics().gauge("serving.queue.depth").set(5)
            for v in (0.5, 0.25, 1.0):
                obs.get_metrics().histogram("serving.latency_s").observe(v)
        with obs.span("second", passed=True):
            pass
    assert not obs.get_tracer().enabled
    paths = cap.trace.save(str(tmp))
    files = {name: open(p).read() for name, p in sorted(paths.items())}
    return files, cap.trace.summary(), json.dumps(cap.trace.chrome())


def test_run_trace_artifacts_equal_the_reference(tmp_path):
    got = _trace_script(tobs, tmp_path / "t")
    want = _trace_script(jobs, tmp_path / "j")
    assert got == want
    files, summary, _ = got
    assert "outer" in summary and "rtl.emulator.seu_flips" in summary
    assert set(files) == {"trace.json", "trace.jsonl", "metrics.json",
                          "summary.txt"}
    rt = tobs.RunTrace.from_tracer("x", tobs.Tracer(), MetricsRegistry())
    assert rt.spans == [] and rt.metrics == {}


@pytest.mark.parametrize("kw", [
    dict(fail_at_steps={3, 7, 11}),
    dict(fail_prob=0.2, seed=5),
    dict(fail_at_steps={2, 30}, fail_prob=0.35, seed=1, max_failures=4),
    dict(fail_prob=1.0, max_failures=3)])
def test_failure_injector_schedule_equals_the_reference(kw):
    def schedule(cls, err):
        inj = cls(**{k: set(v) if isinstance(v, set) else v
                     for k, v in kw.items()})
        fired = []
        for step in range(40):
            try:
                inj.maybe_fail(step)
            except err as e:
                fired.append((step, str(e)))
        return fired

    got = schedule(FailureInjector, PreemptionError)
    assert got == schedule(JFailureInjector, JPreemptionError)
    assert got and len(got) <= kw.get("max_failures", 10)
    assert issubclass(PreemptionError, RuntimeError)


def test_resilience_exports_equal_the_reference():
    import repro_torch.resilience as tres

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.resilience as jres
    assert tres.__all__ == jres.__all__
    assert tres.FAULT_KINDS == jres.FAULT_KINDS
    assert tres.SILENT_KINDS == jres.SILENT_KINDS
    assert (tres.CLOSED, tres.OPEN, tres.HALF_OPEN) == \
        (jres.CLOSED, jres.OPEN, jres.HALF_OPEN)
    assert [f.name for f in dataclasses.fields(tres.GuardPolicy)] == \
        [f.name for f in dataclasses.fields(jres.GuardPolicy)]
    assert tres.GuardPolicy() == tres.GuardPolicy(**dataclasses.asdict(
        jres.GuardPolicy()))
    assert [f.name for f in dataclasses.fields(tres.ResilienceReport)] == \
        [f.name for f in dataclasses.fields(jres.ResilienceReport)]
    assert tobs.RunTrace.__name__ == "RunTrace" and callable(tobs.capture)
