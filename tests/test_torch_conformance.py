"""PyTorch port, the Elastic Node's verification half (main-path stage 5)
against the JAX package: the golden-vector writer byte for byte,
``ConformanceReport``s of ``run_conformance`` and ``fuzz_template`` as
JSON, the error budget and mode-divergence checks, the measurement
protocol's ``ProtocolReport`` and band edges, and ``canary_check`` on both
of its paths.

The reference's own tests of this stage (``tests/test_conformance.py``)
fail at collection under this host's jax, so these tests run the reference
themselves; its modules are imported with the jax deprecation warning
silenced. The port runs on the CPU here (``device="cpu"``).
"""
import math
import os
import types
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp

    from repro.core import report as jreport
    from repro.energy import hw as jhw
    from repro.quant import fixedpoint as jfxp
    from repro.rtl import ir as jir
    from repro.rtl import oplib as joplib
    from repro.rtl.emulator import RTLEmulator as JRTLEmulator
    from repro.rtl.emulator import reference_apply as j_reference_apply
    from repro.verify import conformance as jconf
    from repro.verify import protocol as jproto
    from repro.verify import vectors as jvec

from repro_torch.core import report as treport
from repro_torch.energy import hw as thw
from repro_torch.quant import fixedpoint as tfxp
from repro_torch.rtl import ir as tir
from repro_torch.rtl import oplib as toplib
from repro_torch.rtl.emulator import RTLEmulator, reference_apply
from repro_torch.verify import conformance as tconf
from repro_torch.verify import protocol as tproto
from repro_torch.verify import vectors as tvec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTOR_ROOT = os.path.join(ROOT, "tests", "golden", "vectors")
ARCHS = ("elastic-lstm", "elastic-conv1d")

J = types.SimpleNamespace(fxp=jfxp, ir=jir, oplib=joplib, conf=jconf,
                          proto=jproto, vec=jvec, hw=jhw, report=jreport)
T = types.SimpleNamespace(fxp=tfxp, ir=tir, oplib=toplib, conf=tconf,
                          proto=tproto, vec=tvec, hw=thw, report=treport)


def _t_conformance(*args, **kw):
    return tconf.run_conformance(*args, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# Golden vectors: the writer half
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_emit_golden_regenerates_checked_in_set(arch, tmp_path):
    vs = tvec.emit_golden(arch, str(tmp_path), device="cpu")
    for name in (tvec.VECTORS_NPZ, tvec.VECTORS_MANIFEST):
        want = open(os.path.join(VECTOR_ROOT, arch, name), "rb").read()
        have = (tmp_path / arch / name).read_bytes()
        assert have == want, name
    back = tvec.load_vectors(str(tmp_path / arch))
    np.testing.assert_array_equal(back.response, vs.response)
    # saving the same set again gives the same bytes
    tvec.save_vectors(vs, str(tmp_path / "again"))
    for name in (tvec.VECTORS_NPZ, tvec.VECTORS_MANIFEST):
        assert (tmp_path / "again" / name).read_bytes() == \
            (tmp_path / arch / name).read_bytes()


def test_vector_set_head_and_floats_match_reference():
    t_vs = tvec.load_vectors(tvec.golden_dir(VECTOR_ROOT, "elastic-lstm"))
    j_vs = jvec.load_vectors(jvec.golden_dir(VECTOR_ROOT, "elastic-lstm"))
    np.testing.assert_array_equal(t_vs.stimulus_f(), j_vs.stimulus_f())
    for n in (1, 4, 100):
        t_h, j_h = t_vs.head(n), j_vs.head(n)
        np.testing.assert_array_equal(t_h.stimulus, j_h.stimulus)
        np.testing.assert_array_equal(t_h.response, j_h.response)
        assert t_h.meta == j_h.meta and t_h.n_vectors == j_h.n_vectors
    with pytest.raises(ValueError, match="n >= 1"):
        t_vs.head(0)


# --------------------------------------------------------------------------- #
# Differential conformance
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("extra", (0, 64))
def test_run_conformance_report_matches_reference(arch, extra):
    """Golden replay plus, optionally, 64 seeded windows: the port's report
    is the reference's, JSON for JSON."""
    tg, jg = tvec.canonical_graph(arch)[0], jvec.canonical_graph(arch)[0]
    t_vs = tvec.load_vectors(tvec.golden_dir(VECTOR_ROOT, arch))
    j_vs = jvec.load_vectors(jvec.golden_dir(VECTOR_ROOT, arch))
    stim = None
    if extra:
        e = tg.edges[tg.inputs[0]]
        stim = np.random.default_rng(extra).integers(
            e.fmt.lo, e.fmt.hi + 1, (extra, *e.shape)).astype(np.int32)
    got = _t_conformance(tg, t_vs, extra_stimulus=stim)
    want = jconf.run_conformance(jg, j_vs, extra_stimulus=stim)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert got.passed and got.golden_match and got.modes_bit_exact
    assert got.oracle_max_lsb == 0 and got.n_vectors == 16 + extra


@pytest.mark.parametrize("arch", ARCHS)
def test_run_conformance_generated_set_matches_reference(arch):
    """No stored set: the design's vectors are generated on the fly (no
    golden replay unless asked)."""
    tg, jg = tvec.canonical_graph(arch)[0], jvec.canonical_graph(arch)[0]
    for replay in (None, True):
        got = _t_conformance(tg, replay_golden=replay, modes=("jnp", "fused"))
        want = jconf.run_conformance(jg, replay_golden=replay,
                                     modes=("jnp", "fused"))
        assert got.to_json() == want.to_json()
        assert got.golden_match is (None if replay is None else True)


@pytest.mark.parametrize("kind", ["act_apply", "act_lut", "conv1d",
                                  "elementwise", "linear", "lstm_cell"])
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_fuzz_template_matches_reference(kind, seed):
    got = tconf.fuzz_template(kind, seed=seed, device="cpu")
    want = jconf.fuzz_template(kind, seed=seed)
    if want is None:
        assert got is None and kind == "act_lut"
        return
    assert got.to_json() == want.to_json()
    assert got.passed and got.n_vectors == 24


def test_graph_error_budget_is_zero_for_builtins():
    for arch in ARCHS:
        assert tconf.graph_error_budget_lsb(tvec.canonical_graph(arch)[0]) \
            == jconf.graph_error_budget_lsb(jvec.canonical_graph(arch)[0]) \
            == 0


# --------------------------------------------------------------------------- #
# Third-party templates: the budget gates, a diverging mode is reported
# (tests/test_conformance.py:97-165, in both packages)
# --------------------------------------------------------------------------- #


def _double_templates(pkg):
    """y = saturate(2·x + bump(mode)) with a declared budget, one adder and
    no memories — a minimal third-party template, written for ``pkg``."""
    F = pkg.fxp.FxpFormat
    is_torch = pkg is T

    class DoubleNode(pkg.ir.Node):
        def __init__(self, **kw):
            self.fmt = kw.pop("fmt", F(8, 4))
            super().__init__(**kw)

    class Double(pkg.oplib.HWTemplate):
        kind = "double_test"
        node_cls = DoubleNode
        bump = {}
        budget = 0

        def execute(self, n, env, em, mode):
            x = env[n.inputs[0]]
            b = self.bump.get(mode, 0)
            if is_torch:
                y = torch.clamp(2 * x.to(torch.int32) + b, n.fmt.lo,
                                n.fmt.hi)
            else:
                y = jnp.clip(2 * x.astype(jnp.int32) + b, n.fmt.lo,
                             n.fmt.hi)
            env[n.outputs[0]] = y

        def reference(self, n, env, luts):
            env[n.outputs[0]] = pkg.fxp.fxp_quantize(
                2.0 * env[n.inputs[0]], n.fmt)

        def emit(self, graph, n, out):
            out[f"{n.name}.vhd"] = f"entity {n.name} is\nend entity;\n"

        def error_budget_lsb(self, node):
            return self.budget

        def probe_graph(self, rng):
            fmt = F(8, 4)
            g = pkg.ir.Graph(name="probe_double")
            g.edges["x"] = pkg.ir.Edge("x", (4,), fmt)
            g.inputs = ["x"]
            g.add(DoubleNode(name="d0", op=self.kind, inputs=["x"],
                             outputs=["y"], fmt=fmt),
                  pkg.ir.Edge("y", (4,), fmt))
            g.outputs = ["y"]
            return g

    return Double


@pytest.mark.parametrize("case", ["exact", "off-by-one", "declared-slack",
                                  "mode-skew"])
def test_custom_template_reports_match_reference(case):
    """Register → fuzz in both packages: an exact template passes; one whose
    int path is 1 LSB off fails at the default 0-LSB budget and passes once
    it declares that slack; one that diverges in a single mode fails the
    bit-exactness check, not just the oracle."""
    bump, budget = {"exact": ({}, 0), "off-by-one": (
        {"fused": 1, "pallas": 1, "jnp": 1}, 0), "declared-slack": (
        {"fused": 1, "pallas": 1, "jnp": 1}, 1), "mode-skew": (
        {"jnp": 1}, 0)}[case]
    reports = []
    for pkg in (T, J):
        tmpl = _double_templates(pkg)()
        tmpl.bump, tmpl.budget = bump, budget
        pkg.oplib.register_template(tmpl)
        try:
            kw = {"device": "cpu"} if pkg is T else {}
            reports.append(pkg.conf.fuzz_template("double_test", seed=7,
                                                  **kw))
        finally:
            pkg.oplib.unregister_template("double_test")
    got, want = reports
    assert got.to_json() == want.to_json()
    assert "double_test" not in toplib.list_templates()
    if case in ("exact", "declared-slack"):
        assert got.passed and got.error_budget_lsb == budget
    elif case == "off-by-one":
        assert not got.passed and not got.oracle_within_budget
        assert got.oracle_max_lsb >= 1 and got.modes_bit_exact
    else:
        assert not got.passed and not got.modes_bit_exact
        assert got.mode_max_diff["fused-vs-jnp"] > 0


def test_register_twice_is_an_error_unless_overwrite():
    tmpl = _double_templates(T)()
    toplib.register_template(tmpl)
    try:
        with pytest.raises(ValueError, match="already registered"):
            toplib.register_template(tmpl)
        toplib.register_template(tmpl, overwrite=True)
    finally:
        toplib.unregister_template("double_test")
    toplib.unregister_template("double_test")          # absent: no error


# --------------------------------------------------------------------------- #
# The float oracle and the device rule
# --------------------------------------------------------------------------- #


def test_oracle_codes_match_reference_and_hold_f32(monkeypatch):
    """The oracle runs with f32 matmuls in IEEE precision whatever the
    process's TF32 global says, and leaves the global as it found it."""
    from repro_torch.rtl import emulator as temulator

    tg, jg = (tvec.canonical_graph("elastic-lstm")[0],
              jvec.canonical_graph("elastic-lstm")[0])
    x = (np.random.default_rng(4).standard_normal((257, 6, 1)) * 3) \
        .astype(np.float32)
    want = jconf.oracle_codes(jg, x)
    mm = torch.backends.cuda.matmul
    seen = []
    real = temulator.reference_apply

    def spy(*args, **kw):
        seen.append(mm.fp32_precision)
        return real(*args, **kw)

    monkeypatch.setattr(temulator, "reference_apply", spy)
    prev = mm.fp32_precision
    mm.fp32_precision = "tf32"             # a global another phase may set
    try:
        got = tconf.oracle_codes(tg, x, device="cpu")
        assert mm.fp32_precision == "tf32"          # restored after
    finally:
        mm.fp32_precision = prev
    assert seen == ["ieee"]
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_entry_points_mean_cuda_without_a_device(monkeypatch, tmp_path):
    graph = tvec.canonical_graph("elastic-lstm")[0]
    vs = tvec.load_vectors(tvec.golden_dir(VECTOR_ROOT, "elastic-lstm"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tconf.run_conformance(graph, vs),
                 lambda: tconf.fuzz_template("linear"),
                 lambda: tconf.oracle_codes(graph, vs.stimulus_f()),
                 lambda: tvec.emit_golden("elastic-lstm", str(tmp_path)),
                 lambda: tconf.run_conformance(graph, vs,
                                               device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --------------------------------------------------------------------------- #
# Canary
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("path", ["int", "float"])
@pytest.mark.parametrize("n", (1, 4, 100))
def test_canary_check_matches_reference(path, n):
    arch = "elastic-lstm" if n != 4 else "elastic-conv1d"
    tg, jg = tvec.canonical_graph(arch)[0], jvec.canonical_graph(arch)[0]
    t_vs = tvec.load_vectors(tvec.golden_dir(VECTOR_ROOT, arch))
    j_vs = jvec.load_vectors(jvec.golden_dir(VECTOR_ROOT, arch))
    if path == "int":
        t_dep = types.SimpleNamespace(emulator=RTLEmulator(tg, device="cpu"))
        j_dep = types.SimpleNamespace(emulator=JRTLEmulator(jg))
    else:
        def t_dep(x):
            return reference_apply(tg, x, device="cpu")

        def j_dep(x):
            return j_reference_apply(jg, x)
    got = tconf.canary_check(t_dep, t_vs, n=n)
    want = jconf.canary_check(j_dep, j_vs, n=n)
    assert got.to_dict() == want.to_dict()
    assert got.passed and got.path == path and got.n == min(n, 16)


def test_canary_catches_a_flipped_weight_bit():
    graph = tvec.canonical_graph("elastic-lstm")[0]
    vs = tvec.load_vectors(tvec.golden_dir(VECTOR_ROOT, "elastic-lstm"))
    em = RTLEmulator(graph, device="cpu")
    em.prepared("linear_head")["w"][0, 0] ^= 1 << 5
    res = tconf.canary_check(types.SimpleNamespace(emulator=em), vs, n=4)
    assert not res.passed and res.n_mismatch > 0 and res.max_diff > 0


# --------------------------------------------------------------------------- #
# The measurement protocol
# --------------------------------------------------------------------------- #


class _StubDeployment:
    """A deployment that reports a fixed measurement: ``graph`` None means a
    host-executed one."""

    def __init__(self, pkg, graph, hw, latency_s, energy_j, gop_per_j,
                 target="rtl", cost=None):
        self.pkg, self.graph, self.hw, self.target = pkg, graph, hw, target
        self.latency_s, self.energy_j = latency_s, energy_j
        self.gop_per_j = gop_per_j
        self.cost = cost if cost is not None else {}
        self.calls = []

    def measure(self, args, *, model, model_flops, n_runs, warmup, hw):
        self.calls.append((n_runs, warmup, hw))
        return self.pkg.report.MeasurementReport(
            model=model, platform=f"stub-{self.target}",
            latency_s=self.latency_s,
            power_w=self.energy_j / self.latency_s, energy_j=self.energy_j,
            gop_per_j=self.gop_per_j, n_runs=n_runs, target=self.target)


def _stub(pkg, case):
    if case == "host":
        return _StubDeployment(pkg, None, pkg.hw.XC7S15, 1.0, 1.0, 1.0,
                               target="host", cost={"est_latency_s": 1e-12})
    arch = "elastic-conv1d" if case == "rtl-conv1d" else "elastic-lstm"
    graph = pkg.vec.canonical_graph(arch)[0]
    cycles = 156 if arch == "elastic-conv1d" else 5237
    duty = 0.8462 if arch == "elastic-conv1d" else 0.9893
    lat = cycles / 100e6 * (1.2 if case == "rtl-slow" else 1.0)
    energy = pkg.hw.XC7S15.energy_j(lat, duty=duty)
    return _StubDeployment(pkg, graph, pkg.hw.XC7S15, lat, energy,
                           2 * graph.total_macs() / 1e9 / energy)


@pytest.mark.parametrize("case", ["rtl-lstm", "rtl-slow", "rtl-conv1d",
                                  "host", "rtl-lstm-tight"])
def test_run_protocol_report_matches_reference(case):
    reports = []
    for pkg in (T, J):
        dep = _stub(pkg, case)
        proto = pkg.proto.MeasurementProtocol(
            warmup=1, n_runs=3,
            table1_rtol=1e-6 if case == "rtl-lstm-tight" else 0.15)
        model = dep.graph.name if dep.graph is not None else "host-model"
        rep = pkg.proto.run_protocol(dep, (np.zeros(1, np.float32),),
                                     model=model, model_flops=1e6,
                                     protocol=proto)
        assert dep.calls == [(3, 1, None)]
        reports.append(rep)
    got, want = reports
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    names = {c.name: c for c in got.checks}
    if case == "rtl-lstm":
        assert got.passed and "latency_vs_table1_us" in names
    elif case == "rtl-slow":
        assert not got.passed
        assert not names["latency_vs_cycle_model"].passed
    elif case == "rtl-conv1d":
        assert got.passed and "latency_vs_table1_us" not in names
    elif case == "host":
        assert got.passed                       # the blown band is advisory
        assert not names["latency_vs_estimate"].enforced
        assert not names["latency_vs_estimate"].passed
    else:
        assert not got.passed
        assert any("table1" in c.name for c in got.checks
                   if c.enforced and not c.passed)


def test_protocol_defaults_match_reference():
    assert tproto.MeasurementProtocol() == tproto.MeasurementProtocol(
        **vars(jproto.MeasurementProtocol()))
    assert tproto.DEFAULT_N_RUNS == jproto.DEFAULT_N_RUNS == 20
    assert (tproto.TABLE1_LATENCY_US, tproto.TABLE1_POWER_MW,
            tproto.TABLE1_GOP_PER_J) == (jproto.TABLE1_LATENCY_US,
                                         jproto.TABLE1_POWER_MW,
                                         jproto.TABLE1_GOP_PER_J)


@pytest.mark.parametrize("rtol", [0.05, 0.15])
def test_protocol_band_boundary_is_inclusive(rtol):
    """tests/test_conformance.py:374-395, in both packages: a measurement on
    the band edge passes, one just beyond fails, negative references band
    on |reference|, non-finite values never pass."""
    ref = 100.0
    edge = rtol * abs(ref)
    cases = [("hi", ref + edge, ref), ("lo", ref - edge, ref),
             ("hi+", math.nextafter(ref + edge, math.inf), ref),
             ("lo-", math.nextafter(ref - edge, -math.inf), ref),
             ("neg", -ref - edge, -ref), ("nan", math.nan, ref),
             ("inf", math.inf, ref)]
    got = [tproto._band(n, v, r, rtol).passed for n, v, r in cases]
    want = [jproto._band(n, v, r, rtol).passed for n, v, r in cases]
    assert got == want == [True, True, False, False, True, False, False]


def test_compare_matches_reference():
    kw = dict(model="m", target="xc7s15", est_latency_s=52.37e-6,
              est_power_w=0.0704, est_energy_j=3.69e-6)
    mkw = dict(model="m", platform="p", latency_s=57.25e-6, power_w=0.071,
               energy_j=4.06e-6)
    assert treport.compare(treport.SynthesisReport(**kw),
                           treport.MeasurementReport(**mkw)) == \
        jreport.compare(jreport.SynthesisReport(**kw),
                        jreport.MeasurementReport(**mkw))
    assert treport.MeasurementReport(**mkw).to_json() == \
        jreport.MeasurementReport(**mkw).to_json()
    d = dict(model="m", train_loss=0.5, eval_loss=0.25)
    assert treport.DesignReport(**d).to_json() == \
        jreport.DesignReport(**d).to_json()
