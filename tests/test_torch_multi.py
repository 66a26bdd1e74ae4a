"""PyTorch port, multi-design emulation and the program cache, against the
JAX package: ``ProgramLRU``, the emulator's cache counters and
``has_program``, the reference's positional signature, ``iso_key``,
``MultiDesignEmulator`` and ``run_conformance_batch``.

The cases of the reference's ``tests/test_multi.py`` are mirrored one for
one on the port (its ``test_hillclimb_*``/``test_apply_xla_flags_*`` are
about ``experiments/`` and stay with it), and each parity test runs the
same calls through both packages: exact integer equality and equal
counters throughout. On the CPU a program is the eager walk, counted once
when it is built; the card's CUDA Graphs are held in ``test_torch_gpu.py``.
"""
import copy
import dataclasses
import functools
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                       # image lacks hypothesis: use shim
    from _hypothesis_compat import given, settings, st

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import rtl as jrtl
    from repro.rtl.program_cache import ProgramLRU as JProgramLRU
    from repro.verify import conformance as jconf
    from repro.verify import vectors as jvec

from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl import (MultiDesignEmulator, ProgramLRU, RTLEmulator,
                             assert_bit_exact, assert_isomorphic, iso_key,
                             stack_params)
from repro_torch.verify.conformance import run_conformance_batch
from repro_torch.verify.vectors import canonical_graph

ARCHS = ("elastic-lstm", "elastic-conv1d")
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _graph(arch: str, seed: int):
    """Seeded canonical lowering — different seed, different weights, same
    structure (the isomorphic-candidate generator the DSE sweep uses)."""
    return canonical_graph(arch, seed=seed)[0]


@functools.lru_cache(maxsize=None)
def _jgraph(arch: str, seed: int):
    return jvec.canonical_graph(arch, seed=seed)[0]


def _stimulus(graph, batch=4, seed=0):
    in_edge = graph.edges[graph.inputs[0]]
    rng = np.random.default_rng(seed)
    return rng.integers(in_edge.fmt.lo, in_edge.fmt.hi + 1,
                        (batch,) + tuple(in_edge.shape)).astype(np.int32)


def _codes(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# the isomorphism key (the reference's cases)
# ---------------------------------------------------------------------------


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 40), st.integers(0, 40))
def test_iso_key_property_weights_do_not_matter(s1, s2):
    """Perturbing ONLY the trained values never changes the key."""
    for arch in ARCHS:
        g1, g2 = _graph(arch, s1), _graph(arch, s2)
        assert iso_key(g1) == iso_key(g2)
        assert g1.iso_key() == iso_key(g1)      # method == module fn
        if s1 != s2:                            # weights genuinely differ...
            arrays = [
                (getattr(a, f.name), getattr(b, f.name))
                for a, b in zip(g1.nodes, g2.nodes)
                for f in dataclasses.fields(a)
                if isinstance(getattr(a, f.name), np.ndarray)
            ]
            assert any(not np.array_equal(x, y) for x, y in arrays)


def _mutate(graph, what: str):
    g = copy.deepcopy(graph)
    if what == "lut_kind":
        n = next(n for n in g.nodes if n.op == "act_lut")
        n.kind = ("hard_tanh" if n.kind == "hard_sigmoid"
                  else "hard_sigmoid")
    elif what == "lut_size":
        n = next(n for n in g.nodes if n.op == "act_lut")
        n.in_fmt = FxpFormat(n.in_fmt.total_bits + 1, n.in_fmt.frac_bits)
    elif what == "weight_shape":
        for n in g.nodes:
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, np.ndarray):
                    setattr(n, f.name, np.concatenate([v, v], axis=0))
                    return g
        raise AssertionError("no array field found to mutate")
    elif what == "edge_fmt":
        name = sorted(g.edges)[0]
        e = g.edges[name]
        g.edges[name] = dataclasses.replace(
            e, fmt=FxpFormat(e.fmt.total_bits + 2, e.fmt.frac_bits))
    return g


@pytest.mark.parametrize("what",
                         ["lut_kind", "lut_size", "weight_shape", "edge_fmt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_iso_key_distinct_on_structural_change(arch, what):
    base = _graph(arch, 0)
    assert iso_key(_mutate(base, what)) != iso_key(base)


# ---------------------------------------------------------------------------
# one build across isomorphic designs
# ---------------------------------------------------------------------------


def test_isomorphic_designs_share_one_program():
    lru = ProgramLRU(4)
    ems = [RTLEmulator(_graph("elastic-lstm", s), mode="jnp", programs=lru,
                       device=CPU) for s in (0, 1, 2)]
    x = _stimulus(ems[0].graph)
    outs = [_codes(em.run_int(x).outputs) for em in ems]

    # one build TOTAL: designs #1 and #2 reuse #0's program
    assert sum(em.trace_count for em in ems) == 1
    stats = lru.stats()
    assert stats["misses"] == 1 and stats["hits"] == 2
    # has_program probes the shared LRU without building
    assert ems[2].has_program(x.shape, x.dtype)
    # the shared program is weight-GENERIC, not weight-frozen: different
    # params through the same program give different outputs
    assert not np.array_equal(outs[0], outs[1])


def test_distinct_structures_do_not_share_a_program():
    lru = ProgramLRU(4)
    a = RTLEmulator(_graph("elastic-lstm", 0), mode="jnp", programs=lru,
                    device=CPU)
    b = RTLEmulator(_graph("elastic-conv1d", 0), mode="jnp", programs=lru,
                    device=CPU)
    a.run_int(_stimulus(a.graph))
    b.run_int(_stimulus(b.graph))
    assert a.trace_count == 1 and b.trace_count == 1
    assert lru.stats()["misses"] == 2


# ---------------------------------------------------------------------------
# the design axis vs sequential runs — all 3 modes, both shipped archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_vmapped_bit_exact_vs_every_sequential_mode(arch):
    graphs = [_graph(arch, s) for s in (0, 1)]
    x = _stimulus(graphs[0])
    multi = MultiDesignEmulator(graphs, device=CPU)
    out = _codes(multi.run_int(x).outputs)
    assert out.shape[0] == multi.k
    assert multi.trace_count == 1

    for mode in ("jnp", "fused", "pallas"):
        for k, g in enumerate(graphs):
            ref = _codes(RTLEmulator(g, mode=mode, device=CPU).run_int(x)
                         .outputs)
            assert np.array_equal(out[k], ref), (arch, mode, k)

    # the built-in sequential cross-check path agrees too
    assert np.array_equal(out, multi.run_int_sequential(x))


def test_per_design_stimulus_routes_row_k_to_design_k():
    graphs = [_graph("elastic-lstm", s) for s in (0, 1, 2)]
    xs = np.stack([_stimulus(graphs[0], seed=s) for s in range(3)])
    multi = MultiDesignEmulator(graphs, device=CPU)
    out = _codes(multi.run_int(xs, per_design=True).outputs)
    for k, g in enumerate(graphs):
        ref = _codes(multi.emulators[k].run_int(xs[k]).outputs)
        assert np.array_equal(out[k], ref), k
    with pytest.raises(ValueError, match="design axis"):
        multi.run_int(xs[:2], per_design=True)


def test_assert_isomorphic_names_the_offender():
    graphs = [_graph("elastic-lstm", 0), _graph("elastic-conv1d", 0)]
    with pytest.raises(ValueError, match="not program-isomorphic"):
        assert_isomorphic(graphs)
    with pytest.raises(ValueError, match="at least one graph"):
        MultiDesignEmulator([], device=CPU)


def test_run_conformance_batch_cross_checks_every_design():
    reports = run_conformance_batch([_graph("elastic-lstm", s)
                                     for s in (0, 1)], device=CPU)
    assert len(reports) == 2
    for rep in reports:
        assert rep.passed
        assert rep.modes[0] == "vmap-jnp"
        assert rep.modes_bit_exact and rep.oracle_within_budget
        vs = {k: v for k, v in rep.mode_max_diff.items()
              if k.startswith("vmap-jnp-vs-")}
        assert vs and all(v == 0 for v in vs.values())


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _lru_script(lru_cls):
    """One scripted sequence of get_or_build / probes / clear; returns
    everything observable."""
    lru = lru_cls(3)
    seen = []
    for key in ("a", "b", "a", "c", "d", "b", "a", "e", "a", "d"):
        prog, hit, ev = lru.get_or_build(key, lambda key=key: f"p-{key}")
        seen.append((prog, hit, ev, "b" in lru, len(lru)))
    seen.append(lru.stats())
    lru.clear()
    seen.append((lru.stats(), "a" in lru, len(lru)))
    with pytest.raises(ValueError, match="max_programs"):
        lru_cls(0)
    return seen


def test_program_lru_stats_equal_the_reference():
    assert _lru_script(ProgramLRU) == _lru_script(JProgramLRU)
    lru, jlru = ProgramLRU(2), JProgramLRU(2)
    for cache in (lru, jlru):
        for key in ("k", "k", "j", "i"):
            cache.get_or_build(key, lambda: 1)
    assert repr(lru) == repr(jlru)


def test_program_lru_is_thread_safe_under_8_threads():
    lru = ProgramLRU(max_programs=2)
    built, errors = [], []

    def hammer():
        try:
            for i in range(300):
                key = ("k", i % 5)

                def factory(key=key):
                    built.append(key)
                    return key

                prog, _hit, _ev = lru.get_or_build(key, factory)
                assert prog == key          # never another key's program
                assert isinstance(key in lru, bool)
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)            # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    s = lru.stats()
    assert s["hits"] + s["misses"] == 8 * 300
    assert s["misses"] == len(built)        # every miss built exactly once
    assert s["evictions"] == s["misses"] - s["size"]
    assert s["size"] <= 2                   # eviction bound respected


#: batch sizes of a scripted sequence: repeats (hits), more distinct
#: shapes than the LRU holds (evictions) and a return to an evicted one
SHAPE_SCRIPT = (4, 4, 7, 1, 4, 9, 7, 2, 4, 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ("fused", "pallas", "jnp"))
def test_cache_stats_and_probes_equal_the_reference(arch, mode):
    g, jg = _graph(arch, 0), _jgraph(arch, 0)
    em = RTLEmulator(g, mode=mode, max_programs=3, device=CPU)
    jem = jrtl.RTLEmulator(jg, mode=mode, max_programs=3)
    probes = [(b,) + tuple(g.edges[g.inputs[0]].shape)
              for b in sorted(set(SHAPE_SCRIPT))]
    for b in SHAPE_SCRIPT:
        x = _stimulus(g, batch=b, seed=b)
        got, want = em.run_int(x), jem.run_int(x)
        np.testing.assert_array_equal(_codes(got.outputs),
                                      np.asarray(want.outputs, np.int64))
        assert [em.has_program(s, np.int32) for s in probes] == \
            [jem.has_program(s, np.int32) for s in probes], b
        assert em.cache_stats() == jem.cache_stats(), b
    assert em.cache_stats()["evictions"] > 0
    assert em.iso_key == jem.iso_key
    # the int32 key: a float probe of the same shape holds nothing
    assert em.has_program(probes[0], np.float32) == \
        jem.has_program(probes[0], np.float32)


def test_isomorphic_emulators_build_once_as_in_the_reference():
    lru, jlru = ProgramLRU(4), JProgramLRU(4)
    ems = [RTLEmulator(_graph("elastic-lstm", s), programs=lru, device=CPU)
           for s in (0, 1, 2)]
    jems = [jrtl.RTLEmulator(_jgraph("elastic-lstm", s), programs=jlru)
            for s in (0, 1, 2)]
    x = _stimulus(ems[0].graph, batch=5)
    for em, jem in zip(ems, jems):
        np.testing.assert_array_equal(
            _codes(em.run_int(x).outputs),
            np.asarray(jem.run_int(x).outputs, np.int64))
    assert [em.trace_count for em in ems] == \
        [jem.trace_count for jem in jems] == [1, 0, 0]
    assert [em.cache_stats() for em in ems] == \
        [jem.cache_stats() for jem in jems]
    assert lru.stats() == jlru.stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_positional_use_pallas_false_is_the_jnp_walk(arch):
    """``RTLEmulator(g, False)`` is the reference's ``jnp`` walk (the
    port's old signature took ``mode`` second and raised here)."""
    g, jg = _graph(arch, 0), _jgraph(arch, 0)
    x = _stimulus(g, batch=9, seed=3)
    em = RTLEmulator(g, False, device=CPU)
    jem = jrtl.RTLEmulator(jg, False)
    assert em.mode == jem.mode == "jnp"
    got, want = em.run_int(x), jem.run_int(x)
    np.testing.assert_array_equal(_codes(got.outputs),
                                  np.asarray(want.outputs, np.int64))
    for k, v in want.trace.items():
        np.testing.assert_array_equal(_codes(got.trace[k]),
                                      np.asarray(v, np.int64), err_msg=k)
    assert RTLEmulator(g, True, device=CPU).mode == \
        jrtl.RTLEmulator(jg, True).mode == "fused"
    assert RTLEmulator(g, False, "pallas", device=CPU).mode == \
        jrtl.RTLEmulator(jg, False, "pallas").mode == "pallas"
    floats = (x / g.edges[g.inputs[0]].fmt.scale).astype(np.float32)
    assert_bit_exact(g, floats, False, device=CPU)
    jrtl.assert_bit_exact(jg, floats, False)
    with pytest.raises(TypeError, match="mode= by keyword"):
        RTLEmulator(g, "jnp", device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_iso_key_equals_the_reference(arch):
    for seed in (0, 1):
        assert iso_key(_graph(arch, seed)) == jrtl.iso_key(_jgraph(arch,
                                                                   seed))
    for what in ("lut_kind", "lut_size", "weight_shape", "edge_fmt"):
        assert iso_key(_mutate(_graph(arch, 0), what)) != \
            iso_key(_graph(arch, 0))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_design", (False, True))
def test_multi_design_codes_equal_the_reference(arch, per_design):
    seeds = (0, 1, 2)
    multi = MultiDesignEmulator([_graph(arch, s) for s in seeds], device=CPU)
    jmulti = jrtl.MultiDesignEmulator([_jgraph(arch, s) for s in seeds])
    g = multi.graphs[0]
    x = np.stack([_stimulus(g, batch=6, seed=s) for s in seeds]) \
        if per_design else _stimulus(g, batch=6)
    got = multi.run_int(x, per_design=per_design)
    want = jmulti.run_int(x, per_design=per_design)
    np.testing.assert_array_equal(_codes(got.outputs),
                                  np.asarray(want.outputs, np.int64))
    np.testing.assert_array_equal(got.outputs_f.numpy(),
                                  np.asarray(want.outputs_f))
    assert sorted(got.trace) == sorted(want.trace)
    for k, v in want.trace.items():
        np.testing.assert_array_equal(_codes(got.trace[k]),
                                      np.asarray(v, np.int64), err_msg=k)
    assert multi.trace_count == jmulti.trace_count == 1
    multi.run_int(x, per_design=per_design)
    jmulti.run_int(x, per_design=per_design)
    assert multi.trace_count == jmulti.trace_count == 1
    assert multi.programs.stats() == jmulti.programs.stats()
    assert multi.iso_key == jmulti.iso_key
    if not per_design:
        np.testing.assert_array_equal(multi.run_int_sequential(x),
                                      jmulti.run_int_sequential(x))


def test_stack_params_leads_with_the_design_axis():
    ems = [RTLEmulator(_graph("elastic-lstm", s), device=CPU)
           for s in (0, 1)]
    stacked = stack_params(ems)
    assert sorted(stacked) == sorted(ems[0].params())
    for name, arrays in stacked.items():
        for k, v in arrays.items():
            assert v.shape[0] == 2
            for i, em in enumerate(ems):
                assert torch.equal(v[i], em.params()[name][k])


def test_sharded_design_axis_equals_one_program():
    """``shard=True`` over a device list that divides K: each device runs
    its share of the designs, gathered equal to the unsplit program."""
    graphs = [_graph("elastic-conv1d", s) for s in range(4)]
    x = _stimulus(graphs[0], batch=5)
    whole = MultiDesignEmulator(graphs, device=CPU)
    split = MultiDesignEmulator(graphs, shard=True, device=CPU,
                                devices=[CPU, CPU])
    assert split.sharded and not whole.sharded
    assert not MultiDesignEmulator(graphs, shard=True, device=CPU,
                                   devices=[CPU] * 3).sharded   # 3 ∤ 4
    for per_design in (False, True):
        xi = np.stack([x + i % 2 for i in range(4)]) if per_design else x
        assert torch.equal(split.run_int(xi, per_design=per_design).outputs,
                           whole.run_int(xi, per_design=per_design).outputs)
    assert split.trace_count == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_run_conformance_batch_reports_equal_the_reference(arch):
    seeds = (0, 1, 2)
    reps = run_conformance_batch([_graph(arch, s) for s in seeds],
                                 device=CPU)
    jreps = jconf.run_conformance_batch([_jgraph(arch, s) for s in seeds])
    assert [r.to_dict() for r in reps] == [r.to_dict() for r in jreps]
    assert all(r.passed for r in reps)
    stim = _stimulus(_graph(arch, 0), batch=33, seed=7)
    reps = run_conformance_batch([_graph(arch, s) for s in seeds],
                                 stimulus=stim, modes=("jnp", "fused"),
                                 device=CPU)
    jreps = jconf.run_conformance_batch([_jgraph(arch, s) for s in seeds],
                                        stimulus=stim, modes=("jnp", "fused"))
    assert [r.to_dict() for r in reps] == [r.to_dict() for r in jreps]


@pytest.mark.parametrize("mode", ("fused", "pallas", "jnp"))
def test_a_result_survives_the_next_call_on_its_program(mode):
    g = _graph("elastic-lstm", 0)
    em = RTLEmulator(g, mode=mode, device=CPU)
    x1, x2 = _stimulus(g, batch=8, seed=1), _stimulus(g, batch=8, seed=2)
    first = em.run_int(x1)
    kept = {k: v.clone() for k, v in first.trace.items()}
    second = em.run_int(x2)                       # same program: a hit
    assert em.cache_stats()["hits"] == 1
    for k, v in kept.items():
        assert torch.equal(first.trace[k], v), k
    assert not torch.equal(first.outputs, second.outputs)


def test_one_emulator_serves_8_threads():
    """Farm worker threads share one emulator and its program: every
    thread's answers equal its solo runs, the counters add up."""
    g = _graph("elastic-lstm", 0)
    em = RTLEmulator(g, device=CPU)
    xs = [_stimulus(g, batch=16, seed=s) for s in range(8)]
    want = [_codes(RTLEmulator(g, device=CPU).run_int(x).outputs)
            for x in xs]
    errors = []

    def serve(i):
        try:
            for _ in range(20):
                got = _codes(em.run_int(xs[i]).outputs)
                assert np.array_equal(got, want[i])
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert em.cache_stats()["dispatches"] == {"fused": 160}
    assert em.trace_count == 1
