"""PyTorch port, IR and lowering: iso keys, node order, quantized weights
and ROM tables against the JAX reference; parameter conversion."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.model.layers import init_params
from repro.model.lstm import lstm_schema as j_lstm_schema
from repro.rtl import ir as jir
from repro.rtl import oplib as joplib
from repro.verify import vectors as jvec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.types import LSTMConfig
from repro_torch.quant.fixedpoint import FxpFormat
from repro_torch.rtl import ir as tir
from repro_torch.rtl import oplib as toplib
from repro_torch.verify import vectors as tvec

ARCHS = ("elastic-lstm", "elastic-conv1d")
PROBE_KINDS = ("linear", "lstm_cell", "conv1d", "act_apply", "elementwise")


def assert_same_graph(tg, jg):
    """Same iso key STRING, node order/names/kinds, edges, and identical
    integer weights, biases and ROM tables."""
    assert tg.iso_key() == jg.iso_key()
    assert [(n.name, n.op, type(n).__name__) for n in tg.nodes] == \
        [(n.name, n.op, type(n).__name__) for n in jg.nodes]
    assert (tg.inputs, tg.outputs) == (jg.inputs, jg.outputs)
    assert {k: (e.shape, str(e.fmt)) for k, e in tg.edges.items()} == \
        {k: (e.shape, str(e.fmt)) for k, e in jg.edges.items()}
    for tn, jn in zip(tg.nodes, jg.nodes):
        for attr in ("weight_int", "bias_int", "table"):
            if hasattr(jn, attr):
                want = getattr(jn, attr)()
                got = getattr(tn, attr)()
                assert got.dtype == want.dtype, (tn.name, attr)
                np.testing.assert_array_equal(got, want, err_msg=tn.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_canonical_design_matches_reference(arch):
    tg, tcfg, tparams = tvec.canonical_graph(arch)
    jg, jcfg, jparams = jvec.canonical_graph(arch)
    assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tparams["head_w"],
                                  np.asarray(jparams["head_w"]))


def test_canonical_lstm_iso_key_pinned():
    tg, _, _ = tvec.canonical_graph("elastic-lstm")
    assert tg.iso_key() == "60e4c5467e71968a"
    assert [n.name for n in tg.nodes] == [
        "hard_sigmoid_lut", "hard_tanh_lut", "lstm_cell_l0", "linear_head"]


@pytest.mark.parametrize("kind", PROBE_KINDS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_probe_graphs_match_reference(kind, seed):
    tg = toplib.get_template(kind).probe_graph(np.random.default_rng(seed))
    jg = joplib.get_template(kind).probe_graph(np.random.default_rng(seed))
    assert_same_graph(tg, jg)


def test_act_lut_has_no_probe_and_registry_lists_reference_kinds():
    assert toplib.get_template("act_lut").probe_graph(
        np.random.default_rng(0)) is None
    assert toplib.list_templates() == joplib.list_templates()
    assert toplib.lowerable_families() == joplib.lowerable_families()
    with pytest.raises(ValueError, match="registered templates"):
        toplib.get_template("nope")
    with pytest.raises(NotImplementedError, match="lowerable families"):
        toplib.lowering_for("dense")


def test_stacked_lstm_lowering_matches_reference():
    tcfg = get_config("elastic-lstm")
    tcfg = tcfg.with_(lstm=LSTMConfig(hidden=8, n_layers=2, in_features=1,
                                      out_features=1, seq_len=6))
    jcfg = j_get_config("elastic-lstm")
    jcfg = jcfg.with_(lstm=type(jcfg.lstm)(hidden=8, n_layers=2,
                                           in_features=1, out_features=1,
                                           seq_len=6))
    tparams = tvec.canonical_params(tvec.schema_for(tcfg), seed=3)
    jparams = jvec.canonical_params(j_lstm_schema(jcfg), seed=3)
    assert_same_graph(tir.lower_model(tcfg, tparams),
                      jir.lower_model(jcfg, jparams))


def test_plain_stack_lowerings_match_reference():
    rng = np.random.default_rng(5)
    layers = [((rng.standard_normal((6, 4)) * 0.4).astype(np.float32),
               (rng.standard_normal(4) * 0.1).astype(np.float32)),
              ((rng.standard_normal((4, 2)) * 0.4).astype(np.float32),
               np.zeros(2, np.float32))]
    assert_same_graph(tir.lower_linear_stack("mlp", layers),
                      jir.lower_linear_stack("mlp", layers))
    blocks = [((rng.standard_normal((3, 2)) * 0.5).astype(np.float32),
               np.zeros(2, np.float32))]
    head = ((rng.standard_normal((12, 1)) * 0.3).astype(np.float32),
            np.zeros(1, np.float32))
    assert_same_graph(
        tir.lower_conv_stack("tcn", blocks, head, seq_len=8, stride=1,
                             act="hard_sigmoid"),
        jir.lower_conv_stack("tcn", blocks, head, seq_len=8, stride=1,
                             act="hard_sigmoid"))


def test_validate_formats_envelope_matches_reference():
    from repro.quant.fixedpoint import FxpFormat as JF

    for act, w, state, fan_in in (((8, 4), (8, 6), (16, 8), 21),
                                  ((12, 6), (12, 6), (16, 8), 21),
                                  ((8, 4), (8, 6), (16, 2), 3)):
        outcomes = []
        for mod, F in ((tir, FxpFormat), (jir, JF)):
            try:
                mod.validate_formats(act=F(*act), weight=F(*w),
                                     state=F(*state), fan_in=fan_in)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch):
    """Reference params (numpy-seeded and jax-PRNG-initialized) carry over
    to the port and lower to the same design."""
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    schema = jvec._schema_for(jcfg)
    for jparams in (jvec.canonical_params(schema, seed=1),
                    init_params(schema, jax.random.PRNGKey(0))):
        tparams = params_from_jax(jparams, tcfg)
        leaves = jax.tree.leaves(jparams)
        assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
                   for a in _leaves(tparams))
        assert len(_leaves(tparams)) == len(leaves)
        assert_same_graph(tir.lower_model(tcfg, tparams),
                          jir.lower_model(jcfg, jparams))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_params_from_jax_rejects_bad_trees():
    cfg = get_config("elastic-lstm")
    good = jvec.canonical_params(jvec._schema_for(j_get_config(
        "elastic-lstm")))
    with pytest.raises(KeyError, match="missing keys"):
        params_from_jax({k: v for k, v in good.items() if k != "head_b"},
                        cfg)
    with pytest.raises(KeyError, match="unexpected keys"):
        params_from_jax({**good, "extra": np.zeros(1)}, cfg)
    bad = {**good, "head_w": np.zeros((3, 1), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg)
    with pytest.raises(ValueError, match="list of 1"):
        params_from_jax({**good, "cells": good["cells"] * 2}, cfg)


def test_get_config_knows_only_paper_designs():
    assert get_config("elastic-conv1d").conv1d.flat_features == 9
    # the hybrid family is ported: its config loads; an unknown id raises
    assert get_config("zamba2-7b").family == "hybrid"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("zamba3-7b")
