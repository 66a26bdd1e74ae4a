"""PyTorch port, the slice as a whole: the integer emulator against the JAX
RTLEmulator (outputs and full trace), the golden sets, the float oracle,
batching, and the device rule — exact integer equality throughout."""
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.model.lstm import lstm_schema as j_lstm_schema
from repro.rtl import ir as jir
from repro.rtl import oplib as joplib
from repro.rtl.emulator import RTLEmulator as JRTLEmulator
from repro.rtl.emulator import reference_apply as j_reference_apply
from repro.verify import vectors as jvec
from repro_torch.configs import get_config
from repro_torch.core.types import LSTMConfig
from repro_torch.rtl import ir as tir
from repro_torch.rtl import oplib as toplib
from repro_torch.rtl.emulator import (RTLEmulator, assert_bit_exact,
                                      outputs_by_mode, reference_apply)
from repro_torch.verify import vectors as tvec

GOLDEN_ROOT = os.path.join(os.path.dirname(__file__), "golden", "vectors")
ARCHS = ("elastic-lstm", "elastic-conv1d")
DESIGNS = ARCHS + ("lstm-2cell",)
MODES = RTLEmulator.MODES
BATCHES = (1, 7, 64, 256)


def _stacked_cfgs():
    tcfg = get_config("elastic-lstm")
    tcfg = tcfg.with_(n_layers=2, lstm=LSTMConfig(
        hidden=20, n_layers=2, in_features=1, out_features=1, seq_len=6))
    jcfg = j_get_config("elastic-lstm")
    jcfg = jcfg.with_(n_layers=2, lstm=type(jcfg.lstm)(
        hidden=20, n_layers=2, in_features=1, out_features=1, seq_len=6))
    return tcfg, jcfg


def _graphs(design):
    """(port graph, reference graph) of one design, same weights."""
    if design in ARCHS:
        return tvec.canonical_graph(design)[0], jvec.canonical_graph(design)[0]
    tcfg, jcfg = _stacked_cfgs()
    tg = tir.lower_model(tcfg, tvec.canonical_params(
        tvec.schema_for(tcfg), seed=11))
    jg = jir.lower_model(jcfg, jvec.canonical_params(
        j_lstm_schema(jcfg), seed=11))
    return tg, jg


@pytest.fixture(scope="module")
def graphs():
    return {d: _graphs(d) for d in DESIGNS}


def _codes(graph, batch, seed):
    e = graph.edges[graph.inputs[0]]
    rng = np.random.default_rng(seed)
    return rng.integers(e.fmt.lo, e.fmt.hi + 1,
                        (batch, *e.shape)).astype(np.int32)


def _assert_same_result(t_res, j_res):
    np.testing.assert_array_equal(t_res.outputs.numpy(),
                                  np.asarray(j_res.outputs))
    np.testing.assert_array_equal(t_res.outputs_f.numpy(),
                                  np.asarray(j_res.outputs_f))
    assert sorted(t_res.trace) == sorted(j_res.trace)
    for k, v in j_res.trace.items():
        np.testing.assert_array_equal(
            t_res.trace[k].numpy().astype(np.int64),
            np.asarray(v).astype(np.int64), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_golden_vectors_replay_exactly(arch, mode):
    vs = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    graph, _, _ = tvec.canonical_graph(arch)
    got = RTLEmulator(graph, mode=mode, device="cpu").run_int(vs.stimulus)
    np.testing.assert_array_equal(got.outputs.numpy(), vs.response)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_vectors_reproduces_golden_set(arch):
    graph, _, _ = tvec.canonical_graph(arch)
    vs = tvec.generate_vectors(graph, device="cpu")
    golden = tvec.load_vectors(tvec.golden_dir(GOLDEN_ROOT, arch))
    np.testing.assert_array_equal(vs.stimulus, golden.stimulus)
    np.testing.assert_array_equal(vs.response, golden.response)
    assert (vs.in_fmt, vs.out_fmt) == (golden.in_fmt, golden.out_fmt)
    assert vs.meta == golden.meta


def test_load_vectors_rejects_tampered_set(tmp_path):
    import json
    import shutil

    src = tvec.golden_dir(GOLDEN_ROOT, "elastic-lstm")
    for name in ("vectors.npz", "manifest.json"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    man = json.loads((tmp_path / "manifest.json").read_text())
    man["response"]["sha256"] = "0" * 64
    (tmp_path / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="sha256"):
        tvec.load_vectors(str(tmp_path))


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("batch", BATCHES)
def test_emulator_matches_reference(graphs, design, batch):
    """Every port mode equals the reference's fused emulator: outputs and
    every traced edge."""
    tg, jg = graphs[design]
    x = _codes(tg, batch, seed=batch)
    want = JRTLEmulator(jg, mode="fused").run_int(x)
    for mode in MODES:
        _assert_same_result(
            RTLEmulator(tg, mode=mode, device="cpu").run_int(x), want)


@pytest.mark.parametrize("mode", ("pallas", "jnp"))
def test_emulator_matches_reference_mode_for_mode(graphs, mode):
    """Mode for mode on conv1d (the reference's own tests hold its three
    modes mutually bit-exact; the fused comparison above covers the
    LSTM designs in every port mode)."""
    tg, jg = graphs["elastic-conv1d"]
    x = _codes(tg, 7, seed=3)
    _assert_same_result(RTLEmulator(tg, mode=mode, device="cpu").run_int(x),
                        JRTLEmulator(jg, mode=mode).run_int(x))


@pytest.mark.parametrize("kind", ("linear", "lstm_cell", "conv1d",
                                  "act_apply", "elementwise"))
def test_template_probes_match_reference(kind):
    for seed in (0, 1):
        tg = toplib.get_template(kind).probe_graph(np.random.default_rng(seed))
        jg = joplib.get_template(kind).probe_graph(np.random.default_rng(seed))
        x = _codes(tg, 9, seed=seed)
        want = JRTLEmulator(jg, mode="jnp").run_int(x)
        for mode in MODES:
            _assert_same_result(
                RTLEmulator(tg, mode=mode, device="cpu").run_int(x), want)


@pytest.mark.parametrize("design", DESIGNS)
def test_reference_apply_matches(graphs, design):
    tg, jg = graphs[design]
    e = tg.edges[tg.inputs[0]]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((33, *e.shape)) * 3).astype(np.float32)
    got = reference_apply(tg, x, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_reference_apply(jg, x)))
    for mode in MODES:
        assert_bit_exact(tg, x, mode=mode, device="cpu")


def test_run_many_ragged_equals_solo_runs(graphs):
    tg, _ = graphs["elastic-lstm"]
    rng = np.random.default_rng(9)
    reqs = [(rng.standard_normal((n, 6, 1)) * 2).astype(np.float32)
            for n in (1, 3, 7, 64, 5)]
    for mode in MODES:
        em = RTLEmulator(tg, mode=mode, device="cpu")
        many = em.run_many(reqs)
        assert len(many) == len(reqs)
        for req, res in zip(reqs, many):
            solo = em.run(req)
            assert torch.equal(res.outputs, solo.outputs)
            assert sorted(res.trace) == sorted(solo.trace)
            for k in solo.trace:
                assert torch.equal(res.trace[k], solo.trace[k]), k
        stacked = em.run_many(np.concatenate(reqs))
        assert torch.equal(stacked.outputs,
                           torch.cat([r.outputs for r in many]))


def test_per_step_schedule_and_dispatch_counts(graphs):
    tg, _ = graphs["lstm-2cell"]
    x = _codes(tg, 16, seed=4)
    em = RTLEmulator(tg, device="cpu")
    fused = em.run_int(x)
    per_step = em.run_int_per_step(x)
    assert torch.equal(fused.outputs, per_step.outputs)
    assert em.dispatch_counts == {"fused": 1, "per_step": 1}
    floats = x.astype(np.float32) / tg.edges["x"].fmt.scale
    assert torch.equal(em.run_per_step(floats).outputs, fused.outputs)
    by_mode = outputs_by_mode(tg, x, device="cpu")
    assert sorted(by_mode) == sorted(MODES)
    for v in by_mode.values():
        np.testing.assert_array_equal(v, fused.outputs.numpy())


def test_params_are_hoisted_int32_on_the_device(graphs):
    tg, _ = graphs["elastic-lstm"]
    em = RTLEmulator(tg, device="cpu")
    params = em.params()
    assert sorted(params) == ["hard_sigmoid_lut", "hard_tanh_lut",
                              "linear_head", "lstm_cell_l0"]
    for arrays in params.values():
        for t in arrays.values():
            assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(params["lstm_cell_l0"]["w"].numpy(),
                                  tg.node("lstm_cell_l0").weight_int())
    assert em.lookup("hard_tanh_lut", torch.tensor([-128, 0, 127])).tolist() \
        == [-16, 0, 16]


def test_no_device_means_cuda_or_raises(graphs, monkeypatch):
    tg, _ = graphs["elastic-lstm"]
    if not torch.cuda.is_available():        # this host: raises as it is
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RTLEmulator(tg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RTLEmulator(tg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RTLEmulator(tg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reference_apply(tg, np.zeros((1, 6, 1), np.float32))
    with pytest.raises(ValueError, match="mode"):
        RTLEmulator(tg, mode="eager", device="cpu")
