"""PyTorch port, the toolchain (main-path stages 2 and 3): static analysis,
the cost model, RTL emission and the lint CLI against the JAX package —
byte-identical artifacts and reports, equal cost reports, the reference's
error messages and exit codes.

The reference's own tests of these stages (``tests/test_rtl.py``,
``tests/test_analyze.py``) fail at collection under this host's jax, so
these tests run the reference themselves; its modules are imported with
the jax deprecation warning silenced.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.energy import hw as jhw
    from repro.quant import fixedpoint as jfxp
    from repro.rtl import analyze as janalyze
    from repro.rtl import diagnostics as jdiag
    from repro.rtl import emit as jemit
    from repro.rtl import ir as jir
    from repro.rtl import lint as jlint
    from repro.rtl import oplib as joplib
    from repro.rtl import resources as jres
    from repro.verify import vectors as jvec

from repro_torch.energy import hw as thw
from repro_torch.quant import fixedpoint as tfxp
from repro_torch.rtl import analyze as tanalyze
from repro_torch.rtl import diagnostics as tdiag
from repro_torch.rtl import emit as temit
from repro_torch.rtl import ir as tir
from repro_torch.rtl import lint as tlint
from repro_torch.rtl import oplib as toplib
from repro_torch.rtl import resources as tres
from repro_torch.rtl.emulator import RTLEmulator
from repro_torch.verify import vectors as tvec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_ROOT = os.path.join(ROOT, "tests", "golden")
ARCHS = ("elastic-lstm", "elastic-conv1d")
PROBE_KINDS = ("linear", "lstm_cell", "conv1d", "act_apply", "elementwise")
DESIGNS = ARCHS + tuple(f"{k}-{s}" for k in PROBE_KINDS for s in range(4))
MODES = RTLEmulator.MODES

J = types.SimpleNamespace(fxp=jfxp, ir=jir, oplib=joplib, analyze=janalyze,
                          diag=jdiag, emit=jemit, res=jres, vec=jvec,
                          hw=jhw, lint=jlint)
T = types.SimpleNamespace(fxp=tfxp, ir=tir, oplib=toplib, analyze=tanalyze,
                          diag=tdiag, emit=temit, res=tres, vec=tvec,
                          hw=thw, lint=tlint)
PKGS = (J, T)


def _design(pkg, name):
    """A canonical design, or ``<kind>-<seed>``: that kind's probe graph
    drawn from a numpy rng of that seed (the same in both packages)."""
    if name in ARCHS:
        return pkg.vec.canonical_graph(name)[0]
    kind, seed = name.rsplit("-", 1)
    return pkg.oplib.get_template(kind).probe_graph(
        np.random.default_rng(int(seed)))


# --------------------------------------------------------------------------- #
# Emission and the cost model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("design", DESIGNS)
def test_emit_graph_byte_identical(design, tmp_path):
    want = jemit.emit_graph(_design(J, design))
    got = temit.emit_graph(_design(T, design))
    assert sorted(got) == sorted(want)
    for name, text in want.items():
        assert isinstance(got[name], str)
        assert got[name] == text, name
    temit.write_artifacts(got, str(tmp_path / "t"))
    jemit.write_artifacts(want, str(tmp_path / "j"))
    for name in want:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    if design in ARCHS:
        golden = os.path.join(GOLDEN_ROOT,
                              design.replace("-", "_") + "_manifest.json")
        with open(golden) as f:
            assert got["manifest.json"] == f.read()


@pytest.mark.parametrize("design", DESIGNS)
def test_cost_model_matches_reference(design):
    tg, jg = _design(T, design), _design(J, design)
    t_est, j_est = tres.estimate(tg), jres.estimate(jg)
    assert dataclasses.asdict(t_est) == dataclasses.asdict(j_est)
    assert (t_est.cycles, t_est.duty, t_est.utilization(), t_est.fits()) \
        == (j_est.cycles, j_est.duty, j_est.utilization(), j_est.fits())
    t_syn = tres.synthesize(tg, hw=thw.get_hw("xc7s15"), n_artifacts=7)
    j_syn = jres.synthesize(jg, hw=jhw.get_hw("xc7s15"), n_artifacts=7)
    assert dataclasses.asdict(t_syn) == dataclasses.asdict(j_syn)
    assert t_syn.to_json() == j_syn.to_json()
    for t_node, j_node in zip(tg.nodes, jg.nodes):
        assert dataclasses.asdict(tres.node_cost(t_node)) == \
            dataclasses.asdict(jres.node_cost(j_node))


def test_table1_cycle_counts():
    """DESIGN.md:102: the Table-I design takes 5,237 cycles (52.37 µs at
    100 MHz); ``elastic-conv1d`` 156."""
    lstm = tres.synthesize(_design(T, "elastic-lstm"))
    conv = tres.synthesize(_design(T, "elastic-conv1d"))
    assert lstm.resources["cycles"] == 5237 and lstm.fits
    assert lstm.est_latency_s == pytest.approx(52.37e-6)
    assert conv.resources["cycles"] == 156 and conv.fits
    assert tres.brams_for(0) == 0 and tres.brams_for(1) == 1
    with pytest.raises(ValueError, match="bits >= 0"):
        tres.brams_for(-1)


def test_hw_specs():
    """XC7S15 is the reference's field for field; the H100 entry takes the
    TPU's place in the port's table."""
    assert dataclasses.asdict(thw.XC7S15) == dataclasses.asdict(jhw.XC7S15)
    assert thw.XC7S15.energy_j(52.37e-6, duty=0.9893) == \
        jhw.XC7S15.energy_j(52.37e-6, duty=0.9893)
    h100 = thw.get_hw("h100-sxm")
    assert h100 is thw.H100_SXM
    assert (h100.peak_flops, h100.hbm_bw, h100.hbm_bytes, h100.active_w) \
        == (989e12, 3.35e12, 80 * 1024 ** 3, 700.0)
    assert sorted(thw.HW_BY_NAME) == ["h100-sxm", "xc7s15"]
    with pytest.raises(KeyError, match="known: \\['h100-sxm', 'xc7s15'\\]"):
        thw.get_hw("tpu-v5e")


# --------------------------------------------------------------------------- #
# Static analysis
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("design", DESIGNS)
def test_analysis_report_json_identical(design):
    t_rep = tanalyze.analyze_graph(_design(T, design))
    j_rep = janalyze.analyze_graph(_design(J, design))
    assert t_rep.to_json() == j_rep.to_json()
    assert t_rep.format() == j_rep.format()
    assert t_rep.passed and t_rep.errors == []
    back = tdiag.AnalysisReport.from_json(t_rep.to_json())
    assert back.to_json() == t_rep.to_json()


@pytest.mark.parametrize("design", DESIGNS)
def test_analysis_is_sound_against_the_emulator(design):
    """Every code the emulator places on an edge, in every mode, lies in
    the statically derived interval (the reference's soundness contract,
    checked through ``RTLEmulator(...).run_int(stim).trace``)."""
    g = _design(T, design)
    rep = tanalyze.analyze_graph(g)
    assert set(rep.intervals) == set(g.edges)
    e = g.edges[g.inputs[0]]
    stim = tvec.stimulus_codes(tuple(e.shape), e.fmt, n_random=24, seed=3)
    for mode in MODES:
        trace = RTLEmulator(g, mode=mode, device="cpu").run_int(stim).trace
        for edge, (lo, hi) in rep.intervals.items():
            v = trace[edge]
            assert lo <= int(v.min()) and int(v.max()) <= hi, (
                design, edge, mode, int(v.min()), int(v.max()), lo, hi)


def _linear_graph(pkg, *, w, d_in=4, d_out=3, w_fmt=(8, 6), in_fmt=(8, 4),
                  out_fmt=(16, 8), edge_out_fmt=None):
    F = pkg.fxp.FxpFormat
    w_fmt, in_fmt, out_fmt = F(*w_fmt), F(*in_fmt), F(*out_fmt)
    g = pkg.ir.Graph(name="neg")
    g.edges["x"] = pkg.ir.Edge("x", (d_in,), in_fmt)
    g.inputs = ["x"]
    g.add(pkg.ir.LinearNode(
        name="lin0", op="linear", inputs=["x"], outputs=["y"],
        weight=np.full((d_in, d_out), w, np.float32),
        bias=np.zeros(d_out, np.float32),
        w_fmt=w_fmt, in_fmt=in_fmt, out_fmt=out_fmt),
        pkg.ir.Edge("y", (d_out,), F(*edge_out_fmt) if edge_out_fmt
                    else out_fmt))
    g.outputs = ["y"]
    return g


def _eai004(pkg):
    g = pkg.oplib.get_template("lstm_cell").probe_graph(
        np.random.default_rng(0))
    g.node("hard_sigmoid_lut").in_fmt = pkg.fxp.FxpFormat(6, 4)
    return g


#: one deliberately broken design per rule, as tests/test_analyze.py builds
#: them: (the graph's maker, error rules, rules fired)
TRIGGERS = {
    "EAI001": (lambda p: _linear_graph(p, w=30000.0, w_fmt=(16, 0),
                                       in_fmt=(16, 0), out_fmt=(16, 0)),
               ["EAI001"], None),
    "EAI002-shift": (lambda p: _linear_graph(p, w=0.0, w_fmt=(32, 31),
                                             in_fmt=(32, 31),
                                             out_fmt=(8, 0)),
                     ["EAI002"], None),
    "EAI002-widening": (lambda p: _linear_graph(p, w=100.0, w_fmt=(16, 0),
                                                in_fmt=(16, 0),
                                                out_fmt=(32, 8)),
                        ["EAI002"], None),
    "EAI003": (lambda p: _linear_graph(p, w=0.1, edge_out_fmt=(8, 4)),
               ["EAI003"], None),
    "EAI004": (_eai004, ["EAI004"], None),
    "EAI005": (lambda p: _linear_graph(p, w=0.0, d_in=2000, d_out=200),
               ["EAI005"], None),
    "EAI006": (lambda p: _linear_graph(p, w=1.0, out_fmt=(8, 4)),
               [], ["EAI006"]),
    "EAI007": (lambda p: _linear_graph(p, w=0.0, d_in=900, d_out=48),
               [], ["EAI007"]),
}


@pytest.mark.parametrize("trigger", sorted(TRIGGERS))
def test_rule_trigger_report_identical(trigger):
    build, errors, fired = TRIGGERS[trigger]
    t_rep = tanalyze.analyze_graph(build(T))
    j_rep = janalyze.analyze_graph(build(J))
    assert t_rep.to_json() == j_rep.to_json()
    assert t_rep.format() == j_rep.format()
    assert sorted({d.rule for d in t_rep.errors}) == errors
    if fired is not None:
        assert t_rep.rules_fired() == fired
    rule = trigger.split("-")[0]
    assert rule in t_rep.rules_fired()
    assert t_rep.passed == (not errors)


def test_every_rule_has_a_trigger():
    assert sorted({k.split("-")[0] for k in TRIGGERS}) == sorted(tdiag.RULES)
    assert {k: dataclasses.asdict(r) for k, r in tdiag.RULES.items()} == \
        {k: dataclasses.asdict(r) for k, r in jdiag.RULES.items()}


def test_diagnostic_contract_matches_reference():
    for pkg in PKGS:
        d = pkg.diag.make_diagnostic("EAI001", "node0", "boom", edge="e0")
        assert d.format("dsn") == "dsn:node0:e0: EAI001 [error] boom"
        assert pkg.diag.Diagnostic.from_dict(d.to_dict()) == d
    t_d = tdiag.make_diagnostic("EAI006", "n", "m")
    j_d = jdiag.make_diagnostic("EAI006", "n", "m")
    assert t_d.to_dict() == j_d.to_dict()
    for bad in (lambda p: p.diag.make_diagnostic("EAI999", "n", "m"),
                lambda p: p.diag.Diagnostic(rule="EAI001", severity="fatal",
                                            node="n", message="m")):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as ei:
                bad(pkg)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    rep = tanalyze.analyze_graph(_design(T, "elastic-lstm"))
    with pytest.raises(ValueError, match="format_version"):
        tdiag.AnalysisReport.from_dict({**rep.to_dict(),
                                        "format_version": 99})


def test_interval_algebra_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        a_lo, a_hi = sorted(int(v) for v in rng.integers(-2**40, 2**40, 2))
        b_lo, b_hi = sorted(int(v) for v in rng.integers(-2**20, 2**20, 2))
        s = int(rng.integers(0, 40))
        fmt = (int(rng.integers(2, 33)), int(rng.integers(0, 16)))
        out = []
        for pkg in PKGS:
            I = pkg.analyze.Interval
            a, b = I(a_lo, a_hi), I(b_lo, b_hi)
            F = pkg.fxp.FxpFormat(*fmt)
            out.append([(iv.lo, iv.hi) if isinstance(iv, I) else iv
                        for iv in (a.add(b), a.mul(b), a.lshift(s),
                                   a.join(b), a.clip(F), I.full(F),
                                   pkg.analyze.requant_interval(a, s),
                                   pkg.analyze.requant_interval(a, -s),
                                   a.covers(b), a.contains(b_lo),
                                   a.magnitude, a.fits_int32(), str(a))])
        assert out[0] == out[1]
    for pkg in PKGS:
        F = pkg.fxp.FxpFormat
        assert pkg.analyze.worst_case_mac_bound(
            4, F(8, 6), F(8, 4), b_magnitude=10) == 4 * 128 * 128 + 10
        with pytest.raises(ValueError, match="empty"):
            pkg.analyze.Interval(3, 2)
        with pytest.raises(ValueError, match="lshift"):
            pkg.analyze.Interval(0, 1).lshift(-1)
    assert tanalyze.worst_case_mac_bound(21, tfxp.FxpFormat(8, 6),
                                         tfxp.FxpFormat(12, 6), 99) == \
        janalyze.worst_case_mac_bound(21, jfxp.FxpFormat(8, 6),
                                      jfxp.FxpFormat(12, 6), 99)


def test_requant_interval_bounds_the_port_requant():
    """[lo >> s, (hi >> s) + 1] contains the port's round-half-even shift
    of every sampled int32 point."""
    import torch

    rng = np.random.default_rng(1)
    v = rng.integers(-2**31, 2**31, 4000, dtype=np.int64)
    wide = tfxp.FxpFormat(32, 0)
    for shift in range(1, 32):
        got = tfxp.fxp_requant_int(torch.from_numpy(v.astype(np.int32)),
                                   shift, wide).numpy()
        for x, q in zip(v[:200], got[:200]):
            iv = tanalyze.requant_interval(tanalyze.Interval(int(x), int(x)),
                                           shift)
            assert iv.contains(int(q)), (x, shift, q, iv)


def _malformed(pkg, case):
    F = pkg.fxp.FxpFormat
    fmt = F(8, 4)
    if case == "unknown-lut":
        g = pkg.oplib.get_template("act_apply").probe_graph(
            np.random.default_rng(0))
        g.node("act_0").lut = "missing_lut"
        return g
    g = pkg.ir.Graph(name="bad")
    g.edges["x"] = pkg.ir.Edge("x", (4,), fmt)
    g.inputs = ["x"]
    g.add(pkg.ir.LinearNode(name="l", op="linear", inputs=["x"],
                            outputs=["y"],
                            weight=np.zeros((4, 2), np.float32),
                            bias=np.zeros(2, np.float32),
                            in_fmt=fmt, out_fmt=fmt),
          pkg.ir.Edge("y", (2,), fmt))
    g.outputs = ["y"]
    if case == "unknown-kind":
        g.node("l").op = "linnear"
    elif case == "ghost-input":
        g.inputs = ["ghost"]
    elif case == "ghost-output":
        g.outputs = ["ghost"]
    elif case == "self-driven":
        g.node("l").inputs[0] = "y"
    elif case == "undeclared-output":
        del g.edges["y"]
    return g


@pytest.mark.parametrize("case", ["unknown-kind", "ghost-input",
                                  "ghost-output", "self-driven",
                                  "undeclared-output", "unknown-lut"])
def test_malformed_graphs_raise_like_the_reference(case):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as ei:
            pkg.analyze.analyze_graph(_malformed(pkg, case))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_default_transfer_is_sound_for_custom_templates():
    class NopTemplate(toplib.HWTemplate):
        kind = "nop"

    fmt = tfxp.FxpFormat(8, 4)
    g = tir.Graph(name="custom")
    g.edges["x"] = tir.Edge("x", (4,), fmt)
    g.inputs = ["x"]
    g.add(tir.Node(name="n0", op="nop", inputs=["x"], outputs=["y"]),
          tir.Edge("y", (4,), fmt))
    g.outputs = ["y"]
    iv = NopTemplate().transfer(g.node("n0"),
                                {"x": tanalyze.Interval(0, 1)},
                                graph=g, ctx=None)
    assert iv == {"y": tanalyze.Interval(fmt.lo, fmt.hi)}
    assert NopTemplate().wire_contract(g.node("n0"), g) == {}
    assert NopTemplate().cost(g.node("n0")) == tres.NodeCost.zero("n0", "nop")
    assert NopTemplate().error_budget_lsb(g.node("n0")) == 0


def test_template_flags_match_reference():
    assert toplib.list_templates() == joplib.list_templates()
    for kind in toplib.list_templates():
        t, j = toplib.get_template(kind), joplib.get_template(kind)
        assert (t.in_netlist, t.sequential, t.has_weights, t.port_in,
                t.port_out, t.family) == \
            (j.in_netlist, j.sequential, j.has_weights, j.port_in,
             j.port_out, j.family), kind


# --------------------------------------------------------------------------- #
# The lint CLI
# --------------------------------------------------------------------------- #


def _run_main(pkg, argv, capsys):
    try:
        rc = pkg.lint.main(argv)
    except SystemExit as e:                 # argparse usage errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out


@pytest.mark.parametrize("argv,rc", [
    (["--arch", "lstm"], 0), (["--arch", "conv1d", "--strict"], 0),
    ([], 0), (["--arch", "nope"], 2), (["--bogus"], 2),
    (["--arch", "lstm", "broken"], 1)])
def test_lint_cli_matches_reference(argv, rc, capsys, monkeypatch):
    if argv[-1:] == ["broken"]:
        # the analyzer sees an EAI001 design in place of the canonical one
        argv = argv[:-1]
        for pkg in PKGS:
            real = pkg.lint.analyze_graph
            bad = TRIGGERS["EAI001"][0](pkg)
            monkeypatch.setattr(pkg.lint, "analyze_graph",
                                lambda g, hw, real=real, bad=bad:
                                real(bad, hw=hw))
    got = _run_main(T, argv, capsys)
    want = _run_main(J, argv, capsys)
    assert got == want
    assert got[0] == rc


def test_lint_json_and_module_entry(tmp_path, capsys):
    paths = {}
    for name, pkg in (("t", T), ("j", J)):
        paths[name] = tmp_path / f"{name}.json"
        assert pkg.lint.main(["--json", str(paths[name])]) == 0
    stdout = capsys.readouterr().out
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    data = json.loads(paths["t"].read_text())
    assert sorted(r["design"] for r in data) == ["elastic-conv1d",
                                                 "elastic-lstm"]
    assert tlint.resolve_arch("conv1d") == "elastic-conv1d"
    assert tlint.resolve_arch("elastic-lstm") == "elastic-lstm"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.rtl.lint"],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert stdout == 2 * proc.stdout        # both packages printed it once
