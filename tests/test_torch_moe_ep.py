"""PyTorch port, the MoE's expert parallelism (``model/moe.py``:
``_capacity``, ``_local_expert_pass``, ``moe_psum``, ``moe_a2a``) against
the reference's on a (2, 4) mesh (the port as 8 ``gloo`` ranks, the
reference with 8 forced host devices: ``tests/torch_ranks.py``), on the
``qwen3-moe-30b-a3b`` smoke config (8 experts, 2 a rank) with the
reference's parameters, at ``capacity_factor`` 8.0 (no assignment dropped)
and at the config's 1.25 (drops). All in float32.

* outputs within 1e-5 of the reference's same impl, ``aux`` within 1e-6
  relative;
* the gradients of ``x`` and of every leaf within 1e-5 (relative rms a
  leaf) of the reference's ``jax.grad``, the same on every rank (the
  helper's autograd gives JAX's transposes: no ``tp``-fold gradient);
* at 8.0, within 2e-4 of the port's ``moe_dense`` (the reference's
  ``tests/test_multidevice.py`` bar), and the gradients of the output's
  loss within 1e-5 of ``moe_dense``'s (the aux losses are different
  estimators: a data shard's load balance against the batch's, as the
  reference's test notes).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_config
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
from repro_torch.model import moe as tmoe
from repro_torch.model.layers import Ctx

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.model import moe as jmoe

KEYS = [f"{c}/{i}" for c in tr.CAPS for i in tr.MOE_IMPLS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("moe_ep"))
    ref = tr.run_ref("moe_ep", d, timeout=300)
    return ref, tr.run_port("moe_ep", 8, d, timeout=300)


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("key", KEYS)
def test_output_against_reference(runs, key):
    ref, port = runs
    for r in port:
        assert float(np.max(np.abs(r[key]["y"] - ref[key]["y"]))) < 1e-5
        assert abs(r[key]["aux"] - ref[key]["aux"]) <= 1e-6 * abs(
            ref[key]["aux"])


@pytest.mark.parametrize("key", KEYS)
def test_gradients_against_reference(runs, key):
    ref, port = runs
    got, want = port[0][key], ref[key]
    assert _rel_rms(got["gx"], want["gx"]) < 1e-5
    assert sorted(got["gp"]) == sorted(want["gp"])
    for leaf in want["gp"]:
        assert _rel_rms(got["gp"][leaf], want["gp"][leaf]) < 1e-5, leaf


@pytest.mark.parametrize("key", KEYS)
def test_every_rank_holds_the_same_gradient(runs, key):
    _, port = runs
    first = port[0][key]
    for r in port[1:]:
        assert np.array_equal(r[key]["y"], first["y"])
        assert np.array_equal(r[key]["gx"], first["gx"])
        for leaf in first["gp"]:
            assert np.array_equal(r[key]["gp"][leaf], first["gp"][leaf])


@pytest.mark.parametrize("impl", ("psum", "a2a"))
def test_no_drop_matches_dense_oracle(runs, impl):
    _, port = runs
    cap = tr.CAPS[0]
    got, dense = port[0][f"{cap}/{impl}"], port[0][f"{cap}/dense"]
    assert float(np.max(np.abs(got["y"] - dense["y"]))) < 2e-4
    got, dense = port[0][f"{cap}/{impl}/y"], port[0][f"{cap}/dense/y"]
    assert _rel_rms(got["gx"], dense["gx"]) < 1e-5
    for leaf in dense["gp"]:
        assert _rel_rms(got["gp"][leaf], dense["gp"][leaf]) < 1e-5, leaf


@pytest.mark.parametrize("impl", ("psum", "a2a"))
def test_mesh_train_step_is_the_meshless_step(runs, impl):
    """One train step on the (2, 4) mesh (the batch over "data", ZeRO-1
    moments, each rank's experts local, the attention, embedding and head
    computed split over "model") against the meshless step from the same
    parameters, with no
    aux loss and nothing dropped: the loss, the global norm (no rank's
    gradient ``tp``-fold) on every rank, and the updated parameters,
    gathered whole to rank 0 alone, within 1e-5 relative."""
    _, port = runs
    for r in port:
        got = r[f"train/{impl}"]
        for key in ("loss", "gnorm"):
            want, have = got[key]
            assert abs(have - want) <= 1e-5 * abs(want), (key, got[key])
    assert all(r[f"train/{impl}"]["params"] is None for r in port[1:])
    for want, have in port[0][f"train/{impl}"]["params"]:
        assert _rel_rms(have, want) < 1e-5


def test_capacity_drops_at_the_config_factor(runs):
    """At 1.25 ``moe_psum`` keeps 5 tokens an expert of each data shard's
    16, and this routing sends up to 7 to one: its output leaves the dense
    oracle's, in both packages. ``moe_a2a``'s 8 slots a destination (4
    tokens a rank, ``_capacity(4) * top_k``) hold every assignment here,
    so it stays on the oracle's."""
    ref, port = runs
    for res in (ref, port[0]):
        dense = res["1.25/dense"]["y"]
        assert float(np.max(np.abs(res["1.25/psum"]["y"] - dense))) > 1e-3
        assert float(np.max(np.abs(res["1.25/a2a"]["y"] - dense))) < 2e-4


def test_impls_are_the_references():
    assert tmoe.IMPLS == {"dense": tmoe.moe_dense, "psum": tmoe.moe_psum,
                          "a2a": tmoe.moe_a2a}
    assert sorted(tmoe.IMPLS) == sorted(jmoe.IMPLS)


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "deepseek-moe-16b"))
@pytest.mark.parametrize("cap", (1.0, 1.25, 8.0))
def test_capacity_is_the_references(arch, cap):
    m = dataclasses.replace(get_config(arch).moe, capacity_factor=cap)
    jm = dataclasses.replace(j_get_config(arch).moe, capacity_factor=cap)
    for t in (1, 7, 64, 512, 2048, 4096):
        assert tmoe._capacity(t, m) == jmoe._capacity(t, jm)


@pytest.mark.parametrize("cap", (4, 16, 64))
def test_local_expert_pass_against_reference(cap):
    """Two of eight experts, each on its ``cap`` heaviest tokens, on
    routing without ties: the reference's sums within 1e-5."""
    rng = np.random.default_rng(cap)
    t, d, f, e = 64, 16, 8, 8
    xt = rng.standard_normal((t, d)).astype(np.float32)
    top_w = rng.random((t, 2)).astype(np.float32)
    top_i = np.stack([rng.permutation(e)[:2] for _ in range(t)]).astype(
        np.int32)
    w = [rng.standard_normal((2, *s)).astype(np.float32) * 0.3
         for s in ((d, f), (d, f), (f, d))]
    want = jmoe._local_expert_pass(
        jnp.asarray(xt), jnp.asarray(top_w), jnp.asarray(top_i),
        *(jnp.asarray(a) for a in w), 2, 2, cap, jnp.float32)
    got = tmoe._local_expert_pass(
        torch.from_numpy(xt), torch.from_numpy(top_w),
        torch.from_numpy(top_i).long(), *(torch.from_numpy(a) for a in w),
        2, 2, cap, torch.float32)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5


def test_tie_at_capacity_keeps_the_lowest_token():
    """The capacity selection is the port's ``top_k``: among tokens of
    equal weight at the boundary, the lowest index is kept (ROADMAP §C5's
    rule; ``jax.lax.top_k``'s order among ties is XLA's own)."""
    xt = torch.eye(6, 4)
    top_w = torch.tensor([[0.5], [0.9], [0.5], [0.5], [0.1], [0.0]])
    top_i = torch.zeros(6, 1, dtype=torch.long)
    ident = torch.eye(4)[None]
    y = tmoe._local_expert_pass(xt, top_w, top_i, ident, ident, ident, 0, 1,
                                3, torch.float32)
    kept = (y.abs().sum(-1) > 0).nonzero().flatten().tolist()
    assert kept == [0, 1, 2]


def test_no_mesh_falls_back_to_dense():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.model.layers import init_params

    p = init_params(tmoe.moe_schema(cfg, tp=1), gen)
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    ctx = Ctx(cfg=cfg, mesh_cfg=SMOKE_MESH, mode="train",
              par=ParallelismConfig(compute_dtype="float32"))
    y_d, a_d = tmoe.moe_dense(p, x, cfg, ctx)
    for fn in (tmoe.moe_psum, tmoe.moe_a2a):
        y, a = fn(p, x, cfg, ctx)
        assert torch.equal(y, y_d) and torch.equal(a, a_d)
