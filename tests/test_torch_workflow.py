"""PyTorch port, the paper's loop (main-path stage 6, second half) against
the JAX package on the CPU: the target registry, ``RTLOptions`` and
``options_from_knobs``, ``RTLTarget``/``RTLExecutable``, the component
registry, ``Creator`` with its deprecated spellings, ``verify_deployment``,
and ``Workflow.run_once`` on the RTL target for both canonical designs.

The loop test feeds both packages' ``Workflow.run_once`` the same
parameters (the reference's init, carried across by
``convert.params_from_jax``) through a fixed ``train_fn``, with
``target="rtl"``, ``verify=True``, ``analyze="error"`` and knobs
``{"bits": 8, "frac": 6}``, and requires equal reports (the synthesis
report, the measurement fields that do not time the host, ``est_vs_meas``,
the analysis JSON, the conformance report), byte-equal artifacts and span
trees of the same names. The reference's own workflow tests fail at
collection under this host's jax, so it runs here, imported with the
deprecation warning silenced.
"""
import dataclasses
import functools
import importlib
import importlib.util
import os
import warnings

import jax
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import obs as jobs
    from repro.configs import get_config as j_get_config
    from repro.core import creator as jcreator
    from repro.core import report as jreport
    from repro.core import target as jtarget
    from repro.core import types as jtypes
    from repro.core import workflow as jworkflow
    from repro.energy import hw as jhw
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.quant import fixedpoint as jfxp
    from repro.rtl import backend as jbackend

from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import creator as tcreator
from repro_torch.core import registry as tregistry
from repro_torch.core import report as treport
from repro_torch.core import target as ttarget
from repro_torch.core import types as ttypes
from repro_torch.core import workflow as tworkflow
from repro_torch.energy import hw as thw
from repro_torch.launch import elastic_workflow as tew
from repro_torch.model.conv1d import conv1d_flops
from repro_torch.model.lstm import lstm_flops
from repro_torch.quant import fixedpoint as tfxp
from repro_torch.rtl import backend as tbackend
from repro_torch.verify import verify_deployment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("elastic-lstm", "elastic-conv1d")
KNOBS = {"bits": 8, "frac": 6}
HOST_TIMED = ("latency_p50_s", "latency_p99_s")


def _example():
    """``examples/elastic_workflow.py``, the reference's workflow script."""
    spec = importlib.util.spec_from_file_location(
        "_ref_elastic_workflow",
        os.path.join(ROOT, "examples", "elastic_workflow.py"))
    mod = importlib.util.module_from_spec(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec.loader.exec_module(mod)
    return mod


def _init(arch):
    jp = jlayers.init_params(jlm.param_schema(j_get_config(arch)),
                             jax.random.PRNGKey(0))
    return jp, to_torch(params_from_jax(jp, get_config(arch)), "cpu")


def _design(arch):
    return dict(model=arch, train_loss=0.25, eval_loss=0.125, params=7,
                weight_fmt="Q8.6", act_fmt="Q8.4")


# --------------------------------------------------------------------------- #
# The target registry, RTLOptions and options_from_knobs
# --------------------------------------------------------------------------- #


def test_target_registry():
    assert ttarget.list_targets() == ["rtl", "xla"]
    tgt = ttarget.get_target("rtl")
    assert tgt is tbackend.RTL_TARGET and isinstance(tgt, ttarget.Target)
    assert ttarget.get_target(tgt) is tgt
    assert (tgt.name, tgt.default_hw, tgt.options_cls,
            tgt.requires_stepper) == ("rtl", thw.XC7S15, tbackend.RTLOptions,
                                      True)
    with pytest.raises(ValueError, match=r"unknown target 'hls'; "
                       r"registered targets: \['rtl', 'xla'\]"):
        ttarget.get_target("hls")
    with pytest.raises(ValueError, match="already registered"):
        ttarget.register_target(tgt)
    with pytest.raises(ValueError, match="already registered"):
        ttarget.register_lazy_target("rtl", "x", "y")
    assert ttarget.DEFAULT_N_RUNS == jtarget.DEFAULT_N_RUNS == 20


def _bad_options(pkg, fxp):
    return [dict(emulator_mode="bogus"), dict(analyze="strict"),
            dict(w_fmt=(8, 6)), dict(act_fmt="Q8.4"),
            dict(w_fmt_overrides={"nope": fxp.FxpFormat(8, 6)}),
            dict(w_fmt_overrides={"act_lut": fxp.FxpFormat(8, 6)}),
            dict(w_fmt_overrides={"linear": (8, 6)})]


@pytest.mark.parametrize("case", range(7))
def test_rtl_options_validation_raises_what_the_reference_raises(case):
    jkw = _bad_options(jbackend, jfxp)[case]
    tkw = _bad_options(tbackend, tfxp)[case]
    with pytest.raises(Exception) as jexc:
        jbackend.RTLOptions(**jkw)
    with pytest.raises(Exception) as texc:
        tbackend.RTLOptions(**tkw)
    assert type(texc.value) is type(jexc.value)
    assert str(texc.value) == str(jexc.value)


def test_options_from_knobs_map_every_width_like_the_reference():
    cases = [{}, {"bits": 8}] + [
        {"bits": b, "frac": f} for b in range(4, 17) for f in (0, 2, 6, 11)
        if f < b]
    for knobs in cases:
        j = jbackend.RTL_TARGET.options_from_knobs(knobs)
        t = tbackend.RTL_TARGET.options_from_knobs(knobs)
        assert [str(getattr(t, k)) for k in ("w_fmt", "act_fmt",
                                              "state_fmt")] == \
            [str(getattr(j, k)) for k in ("w_fmt", "act_fmt", "state_fmt")]
        assert (t.emulator_mode, t.analyze) == (j.emulator_mode, j.analyze)


def test_translate_on_a_clockless_spec_lands_on_the_fpga():
    cfg = get_config("elastic-lstm")
    cr = tcreator.Creator(hw=thw.H100_SXM, device="cpu")
    assert tcreator.Creator().hw is thw.H100_SXM
    st = cr.build(cfg, ttypes.SHAPES_LSTM["infer_1"])
    syn, dep = cr.translate(st, target="rtl")     # params from stepper.init
    assert dep.hw is thw.XC7S15 and syn.target == "xc7s15"
    assert dep.device == torch.device("cpu") and dep.cycles == 5237
    # a spec with a clock is kept
    fast = dataclasses.replace(thw.XC7S15, name="xc7s15-200", clock_hz=200e6)
    syn2, dep2 = tcreator.Creator(hw=fast, device="cpu").translate(
        st, target="rtl")
    assert dep2.hw is fast and syn2.target == "xc7s15-200"
    # the reference falls back the same way from its clock-less default
    jcr = jcreator.Creator()
    jst = jcr.build(j_get_config("elastic-lstm"),
                    jtypes.SHAPES_LSTM["infer_1"])
    jsyn, jdep = jcr.translate(jst, target="rtl")
    assert jdep.hw.name == dep.hw.name and jsyn.target == syn.target


# --------------------------------------------------------------------------- #
# Creator: build/validate, deprecated spellings, measure
# --------------------------------------------------------------------------- #


def test_component_registry():
    comps = tregistry.all_components()
    assert set(comps) <= set(
        importlib.import_module("repro.core.registry").all_components())
    for c in comps.values():
        for path in filter(None, (c.ref, c.template, c.quantized)):
            assert path.startswith("repro_torch."), path
            mod, _, attr = path.rpartition(".")
            try:
                obj = importlib.import_module(path)
            except ModuleNotFoundError:
                obj = getattr(importlib.import_module(mod), attr)
            assert obj is not None
    for arch, smoke in (("elastic-lstm", False), ("elastic-conv1d", False),
                        ("yi-9b", True)):
        got = tregistry.validate_config(get_config(arch, smoke=smoke))
        want = importlib.import_module("repro.core.registry") \
            .validate_config(j_get_config(arch, smoke=smoke))
        assert sorted(got) == sorted(want)
    # the hybrid family's component is ported; an unknown one still raises
    assert tregistry.get("mamba2").template == \
        "repro_torch.kernels.mamba2.ops"
    with pytest.raises(KeyError, match="is not supported by the creator"):
        tregistry.get("mamba3")


def test_creator_deprecated_spellings_and_measure():
    cfg = get_config("elastic-conv1d")
    _, tp = _init("elastic-conv1d")
    cr = tcreator.Creator(hw=thw.XC7S15, device="cpu")
    st = cr.build(cfg, ttypes.SHAPES_CONV1D["infer_1"])
    opts = tbackend.RTLOptions(w_fmt=tfxp.FxpFormat(8, 5))
    syn, dep = cr.translate(st, target="rtl", params=tp, options=opts)
    with pytest.warns(DeprecationWarning, match="backend=..."):
        syn2, dep2 = cr.translate(st, backend="rtl", params=tp,
                                  w_fmt=tfxp.FxpFormat(8, 5))
    assert dataclasses.asdict(syn2) == dataclasses.asdict(syn)
    assert dep2.artifacts == dep.artifacts
    with pytest.warns(DeprecationWarning), \
            pytest.raises(TypeError, match="not both"):
        cr.translate(st, backend="rtl", options=opts,
                     w_fmt=tfxp.FxpFormat(8, 5))
    with pytest.raises(TypeError, match="expects options of type"):
        cr.translate(st, target="rtl", options=ttarget.TargetOptions())
    x = np.zeros((2, 16, 3), np.float32)
    meas = cr.measure(dep, (x,), model="m", model_flops=1.0, n_runs=3)
    assert meas.n_runs == 3 and meas.target == "rtl"
    raw = cr.measure(lambda v: v, (x,), model="m", model_flops=1.0,
                     n_runs=2)
    assert (raw.target, raw.n_runs, raw.power_w) == ("xla", 2, 0.071)
    with pytest.warns(DeprecationWarning, match="measure_rtl"):
        old = cr.measure_rtl(dep, x, model="m", model_flops=1.0, n_runs=3)
    assert old.latency_s == meas.latency_s
    assert tbackend.measure_rtl(dep, x, model="m", model_flops=1.0,
                                n_runs=2).n_runs == 2
    # the serving router's probe reads the emulator's program cache: the
    # measured (2, 16, 3) windows hold a program, another batch does not
    assert dep.holds_program((2, 16, 3), torch.float32)
    assert not dep.holds_program((1, 16, 3), torch.float32)


def test_rtl_measure_keeps_warmup_out_of_the_samples():
    _, tp = _init("elastic-lstm")
    syn, dep = tbackend.translate_rtl(get_config("elastic-lstm"), tp,
                                      device="cpu")
    reg = tobs.MetricsRegistry()
    prev_m = tobs.set_metrics(reg)
    tracer = tobs.Tracer()
    prev_t = tobs.set_tracer(tracer)
    try:
        rep = dep.measure((np.zeros((4, 6, 1), np.float32),), model="m",
                          model_flops=2.0, n_runs=5, warmup=2)
    finally:
        tobs.set_tracer(prev_t)
        tobs.set_metrics(prev_m)
    assert reg.histogram("measure.latency_s.rtl").count == 5
    assert reg.counter("rtl.emulator.dispatch.fused").value == 7
    (root,) = tobs.find_spans(tracer.spans, "rtl.measure")
    assert root.attrs == {"model": "m", "n_runs": 5, "warmup": 2}
    assert len(tobs.children_of(tracer.spans, root)) == 7
    assert rep.n_runs == 5 and rep.latency_s == syn.est_latency_s
    assert 0 < rep.latency_p50_s <= rep.latency_p99_s


def test_workflow_spellings_and_unported_branches():
    cr = tcreator.Creator(hw=thw.XC7S15, device="cpu")
    with pytest.warns(DeprecationWarning, match="backend"):
        wf = tworkflow.Workflow(creator=cr, train_fn=None, step_builder=None,
                                backend="rtl")
    assert wf.target == "rtl"
    with pytest.warns(DeprecationWarning, match="fmt_builder"):
        wf = tworkflow.Workflow(
            creator=cr, train_fn=None, step_builder=None, target="rtl",
            fmt_builder=lambda k: {"w_fmt": tfxp.FxpFormat(k["bits"], 4)})
    assert wf.options_from_knobs({"bits": 6}).w_fmt == tfxp.FxpFormat(6, 4)
    with pytest.warns(DeprecationWarning, match="fmt_builder"):
        wf = tworkflow.Workflow(           # ignored off RTL, as before
            creator=cr, train_fn=None, step_builder=None,
            fmt_builder=lambda k: {"w_fmt": tfxp.FxpFormat(k["bits"], 4)})
    assert wf.target == "xla" and wf.options_from_knobs is None
    _, tp = _init("elastic-lstm")
    rep = treport.DesignReport(**_design("elastic-lstm"))
    # the chaos stage runs (the resilience layer is ported): a transient
    # at call 0 is retried, and the report lands on the record
    from repro_torch.resilience import ChaosSpec, FaultPlan, FaultSpec

    spec = ChaosSpec(plan=FaultPlan(
        faults=(FaultSpec(kind="transient", at_call=0),)), n_requests=3)
    wf = tworkflow.Workflow(
        creator=cr, train_fn=lambda k: (tp, rep, None),
        step_builder=functools.partial(tew.lstm_step_builder, device="cpu"),
        stepper_builder=lambda k: cr.build(
            get_config("elastic-lstm"), ttypes.SHAPES_LSTM["infer_1"]),
        target="rtl", resilience=spec)
    resil = wf.run_once(KNOBS).resilience
    assert resil.n_requests == 3 and resil.retries == 1
    assert resil.requests_ok == 3 and resil.requests_lost == 0
    wf = tworkflow.Workflow(
        creator=cr, train_fn=lambda k: (tp, rep, None),
        step_builder=functools.partial(tew.lstm_step_builder, device="cpu"),
        target="rtl")
    with pytest.raises(ValueError, match="needs stepper_builder"):
        wf.run_once(KNOBS)
    with pytest.raises(ValueError, match="no 'analyze' field"):
        dataclasses.replace(wf, analyze="error")._with_analyze(
            ttarget.TargetOptions())
    req = tworkflow.Requirement(max_eval_loss=0.2)
    assert req.satisfied(rep, treport.MeasurementReport(
        model="m", platform="p", latency_s=1.0, power_w=1.0, energy_j=1.0,
        gop_per_j=1.0))


# --------------------------------------------------------------------------- #
# verify_deployment: the RTL half on a real RTLExecutable, the host half on a
# deployment with no graph
# --------------------------------------------------------------------------- #


class _HostDeployment(ttarget.Deployment):
    target = "host"
    hw = thw.H100_SXM

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def measure(self, args, *, model, model_flops, n_runs=20, warmup=1,
                hw=None):
        return treport.MeasurementReport(
            model=model, platform="host", latency_s=1e-3, power_w=1.0,
            energy_j=1e-3, gop_per_j=1.0, n_runs=n_runs, target=self.target)


def test_verify_deployment_host_half_compares_against_an_oracle():
    x = torch.arange(6, dtype=torch.float32)
    ok = verify_deployment(_HostDeployment(lambda v: (v * 2, {"s": v})),
                           (x,), model="m", model_flops=1.0,
                           oracle=lambda v: (v * 2, {"s": v}))
    assert ok.passed and ok.notes[0].startswith("oracle agreement")
    bad = verify_deployment(_HostDeployment(lambda v: v + 1), (x,),
                            model="m", model_flops=1.0, oracle=lambda v: v)
    assert not bad.passed and "deviates from oracle" in bad.notes[0]
    odd = verify_deployment(_HostDeployment(lambda v: (v, v)), (x,),
                            model="m", model_flops=1.0, oracle=lambda v: v)
    assert not odd.passed and "output structure" in odd.notes[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_deployment_verify_with_golden_vectors_equals_reference(arch):
    from repro.verify import vectors as jvec

    from repro_torch.verify import vectors as tvec

    root = os.path.join(ROOT, "tests", "golden", "vectors")
    jp, tp = _init(arch)
    jsyn, jdep = jbackend.translate_rtl(j_get_config(arch), jp)
    tsyn, tdep = tbackend.translate_rtl(get_config(arch), tp, device="cpu")
    flops = float(lstm_flops(get_config(arch)) if arch == "elastic-lstm"
                  else conv1d_flops(get_config(arch)))
    want = jdep.verify(model=arch, model_flops=flops).to_dict()
    got = tdep.verify(model=arch, model_flops=flops).to_dict()
    assert got == want and got["passed"]
    # a stored set replays: the canonical design's golden vectors
    g = tvec.canonical_graph(arch)[0]
    vs = tvec.load_vectors(tvec.golden_dir(root, arch))
    dep = tbackend.RTLExecutable(graph=g, artifacts={}, hw=thw.XC7S15,
                                 device="cpu")
    rep = verify_deployment(dep, model=arch, model_flops=flops, vectors=vs)
    jg = jvec.canonical_graph(arch)[0]
    jvs = jvec.load_vectors(jvec.golden_dir(root, arch))
    jdep2 = jbackend.RTLExecutable(graph=jg, artifacts={}, hw=jhw.XC7S15)
    want2 = importlib.import_module("repro.verify").verify_deployment(
        jdep2, model=arch, model_flops=flops, vectors=jvs)
    assert rep.to_dict() == want2.to_dict() and rep.golden_match is True


# --------------------------------------------------------------------------- #
# Workflow.run_once on the RTL target, both designs, against the reference
# --------------------------------------------------------------------------- #


def _keeping(creator_cls):
    """A Creator that keeps the last deployment it translated."""

    @dataclasses.dataclass
    class Keep(creator_cls):
        def translate(self, *a, **k):
            self.last = super().translate(*a, **k)
            return self.last

    return Keep


@pytest.fixture(scope="module", params=ARCHS)
def loop(request):
    arch = request.param
    jp, tp = _init(arch)
    ex = _example()
    jcfg = j_get_config(arch)
    jcr = _keeping(jcreator.Creator)(hw=jhw.XC7S15)
    jrep = jreport.DesignReport(**_design(arch))
    jwf = jworkflow.Workflow(
        creator=jcr, train_fn=lambda k: (jp, jrep, None),
        step_builder=ex.BUILDERS[arch][1],
        stepper_builder=lambda k: jcr.build(
            jcfg, jtypes.shape_table_for(jcfg)["infer_1"]),
        target="rtl", verify=True, analyze="error")
    with jobs.capture("ref") as cap:
        jrec = jwf.run_once(dict(KNOBS))
    jspans = cap.trace.spans

    twf = tew.build_workflow(arch, device="cpu", verify=True, target="rtl")
    trep = treport.DesignReport(**_design(arch))
    tcr = _keeping(tcreator.Creator)(hw=twf.creator.hw,
                                     device=twf.creator.device)
    twf = dataclasses.replace(
        twf, creator=tcr, train_fn=lambda k: (tp, trep, None),
        stepper_builder=lambda k: tcr.build(
            get_config(arch), ttypes.shape_table_for(get_config(arch))
            ["infer_1"]))
    tracer = tobs.Tracer()
    prev = tobs.set_tracer(tracer)
    try:
        trec = twf.run_once(dict(KNOBS))
    finally:
        tobs.set_tracer(prev)
    return arch, jrec, jcr.last[1], jspans, trec, tcr.last[1], tracer.spans


def test_loop_reports_equal(loop):
    arch, jrec, _, _, trec, _, _ = loop
    assert dataclasses.asdict(trec.synthesis) == \
        dataclasses.asdict(jrec.synthesis)
    jm, tm = (dataclasses.asdict(r.measurement) for r in (jrec, trec))
    for key in HOST_TIMED:
        jm.pop(key), tm.pop(key)
    assert tm == jm
    assert trec.est_vs_meas == jrec.est_vs_meas
    assert trec.analysis.to_json() == jrec.analysis.to_json()
    assert trec.conformance.to_dict() == jrec.conformance.to_dict()
    assert trec.conformance.passed and trec.analysis.passed
    assert (trec.iteration, trec.knobs, trec.satisfied) == (0, KNOBS, False)


def test_loop_artifacts_byte_equal(loop, tmp_path):
    arch, _, jdep, _, _, tdep, _ = loop
    assert sorted(tdep.artifacts) == sorted(jdep.artifacts)
    assert tdep.artifacts == jdep.artifacts
    jdep.save(str(tmp_path / "ref"))
    tdep.save(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "analysis.json" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_loop_span_trees_have_the_same_names(loop):
    _, _, _, jspans, _, _, tspans = loop
    want = [(d, s.name) for s, d in jobs.span_tree(jspans)]
    got = [(d, s.name) for s, d in tobs.span_tree(tspans)]
    assert got == want
    names = {n for _, n in got}
    assert {"workflow.run_once", "workflow.stage1", "workflow.stage2",
            "workflow.stage3", "workflow.verify", "workflow.analyze",
            "creator.translate", "rtl.lower", "rtl.analyze", "rtl.emit",
            "rtl.synthesize", "rtl.measure", "rtl.emulator.dispatch",
            "verify.conformance", "verify.protocol"} <= names
