"""PyTorch port, the ``"model"`` split of the transformer families' steps
(``model/lm.py``: ``_model_specs``, the split train step and
``Server(mesh=)``; ``layers.py``'s MLP, embedding and head,
``attention.py``'s heads, ``moe.py``'s shared experts, the
vocabulary-parallel cross-entropy and ``shardmap.logsumexp``) against the
reference's XLA-partitioned steps on (2, 2) and (2, 4) meshes (the port
as 4 and 8 ``gloo`` ranks, the reference with 8 forced host devices:
``tests/torch_ranks.py``), from the reference's parameters, in f32:

* the yi-9b smoke (4 q heads, 2 kv heads: the kv heads split at a model
  axis of 2, replicated at 4, where each rank's q head reads the kv head
  of its group), also under ``scan_layers`` (the stacked leaves split one
  dim later), the internvl2-1b smoke with 6 q heads (its attention
  split at 2, whole at 4, its MLP and tied vocabulary split at both) and
  the deepseek-moe-16b smoke (shared experts, a dense first layer) with
  each MoE impl;
* the loss within 1e-5 (relative) and each gradient leaf within 1e-5
  (relative rms) of the reference's and of the port's whole-step form,
  every rank gathering the same gradients; 3 steps of the mesh
  ``Trainer`` within 1e-4 of the reference's losses;
* ``Server(mesh=)``'s greedy tokens (prefill, then decode) equal to the
  reference's ``Server(mesh=)`` and to the port's meshless ``Server``,
  the rank's cache holding its kv heads where they split;
* the split step gathers no leaf over ``"model"`` (``CommDebugMode``
  sees no ``DTensor`` all-gather), and the helper's wire bytes are the
  sums the shapes call for: the activations' partial sums, the
  cross-entropy's, its row maxima and the gradients' reduction over
  ``"data"``.

The reference's jobs run side by side, then the port's two.
"""
import concurrent.futures
import warnings

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.types import MeshConfig
from repro_torch.model import attention as tattn
from repro_torch.model import lm as tlm
from repro_torch.model.layers import Ctx, is_pspec, shard_axis, tree_leaves
from repro_torch.shardmap import P

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import get_config as j_get_config

MESHES = ("2x2", "2x4")
WORLD = {"2x2": 4, "2x4": 8}
CASES = [(v, m) for m in MESHES for v in tr.TP_VARIANTS]
SERVED = [(v, m) for m in MESHES for v in tr.TP_SERVED]
# each job takes under 60 s on an idle 8-core host, under 150 s beside
# the rest of the suite on 6 workers
TIMEOUT = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    jobs = [(m, g) for m in MESHES for g in tr.TP_GROUPS]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        refs = list(ex.map(lambda a: tr.run_ref("tp", d, TIMEOUT, a), jobs))
        ports = dict(zip(MESHES, ex.map(
            lambda m: tr.run_port("tp", WORLD[m], d, TIMEOUT), MESHES)))
    ref = {m: {} for m in MESHES}
    for (m, _), r in zip(jobs, refs):
        ref[m].update(r)
    return ref, ports


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _cfg(name):
    return tr._tp_cfg(get_config, name)


def _tp(mesh: str) -> int:
    return tr._tp_mesh(mesh)[1]


@pytest.mark.parametrize("name,mesh", CASES)
def test_split_step_against_reference_and_whole_form(runs, name, mesh):
    ref, ports = runs
    got = ports[mesh][0][name]
    want = ref[mesh][name]
    for loss in (want["loss"], got["whole"]["loss"]):
        assert abs(got["split"]["loss"] - loss) <= 1e-5 * abs(loss)
    ref_g = tree_leaves(params_from_jax(want["grads"], _cfg(name)))
    split_g = tree_leaves(got["split"]["grads"])
    whole_g = tree_leaves(got["whole"]["grads"])
    assert len(split_g) == len(ref_g) == len(whole_g)
    for i, (g, r, w) in enumerate(zip(split_g, ref_g, whole_g)):
        assert g.shape == r.shape
        assert _rel_rms(g, r) < 1e-5, (i, _rel_rms(g, r))
        assert _rel_rms(g, w) < 1e-5, (i, _rel_rms(g, w))


@pytest.mark.parametrize("name,mesh", CASES)
def test_every_rank_gathers_the_same_result(runs, name, mesh):
    _, ports = runs
    first = ports[mesh][0][name]
    assert len(ports[mesh]) == WORLD[mesh]
    for r in ports[mesh][1:]:
        for form in ("split", "whole"):
            assert r[name][form]["digest"] == first[form]["digest"]
            assert r[name][form]["loss"] == first[form]["loss"]


@pytest.mark.parametrize("name,mesh", CASES)
def test_mesh_trainer_against_reference(runs, name, mesh):
    ref, ports = runs
    got = np.asarray(ports[mesh][0][name]["train_losses"])
    want = ref[mesh][name]["train_losses"]
    assert got.shape == want.shape == (tr.TP_STEPS,)
    assert float(np.max(np.abs(got - want))) < 1e-4


@pytest.mark.parametrize("name,mesh", SERVED)
def test_server_greedy_tokens(runs, name, mesh):
    """Prefill then ``TP_NEW - 1`` decode ticks of two requests: the
    reference's ``Server(mesh=)``'s tokens and the meshless ``Server``'s,
    on every rank; the rank's cache holds ``n_kv_heads / tp`` heads where
    they split over ``"model"``, all of them where they do not."""
    ref, ports = runs
    cfg = _cfg(name)
    tp = _tp(mesh)
    kv = cfg.n_kv_heads
    want_kv = kv // tp if shard_axis(kv, tp) else kv
    for r in ports[mesh]:
        got = r[name]
        assert got["tokens"] == ref[mesh][name]["tokens"]
        assert got["meshless_tokens"] == got["tokens"]
        assert got["cache_kv_heads"] == want_kv
        assert all(len(t) == tr.TP_NEW for t in got["tokens"])


@pytest.mark.parametrize("mesh", MESHES)
def test_split_step_gathers_no_leaf_and_sums_what_the_shapes_say(runs,
                                                                  mesh):
    """The yi-9b smoke with no recompute and one CE pass
    (``tr._tp_counter``), on every rank. The split step: no ``DTensor``
    all-gather or reduce-scatter (the leaves enter as they lie; the
    gradient of each leaf whole on every rank, the norms', is summed over
    ``"model"`` by one ``DTensor`` all-reduce); over ``"model"`` the
    embedding's, each
    attention's and MLP's partial sums, forward and backward ((B/dp, S, D)
    f32 each, 4 L + 2 of them), the CE's sum of exponentials and gold
    logit, forward and backward ((B/dp, S) f32, 4 of them), its row maxima
    gathered ((B/dp, S) f32 from each other rank) and nothing else; over
    ``"data"`` every gradient block and the 4 scalars of loss and
    metrics. The whole-step form gathers each leaf split over
    ``"model"``."""
    _, ports = runs
    cfg = get_config("yi-9b", smoke=True)
    dp, tp = tr._tp_mesh(mesh)
    bl, s, d, layers = tr.TP_B // dp, tr.TP_S, cfg.d_model, cfg.n_layers
    ring_m = 2 * (tp - 1) / tp
    ring_d = 2 * (dp - 1) / dp
    for r in ports[mesh]:
        split, whole = r["counter"]["split"], r["counter"]["whole"]
        data = ring_d * (4 * split["grad_numel"] + 4 * 4)
        model = ring_m * 4 * (bl * s * d * (4 * layers + 2) + 4 * bl * s)
        assert split["wire"] == {"all-reduce": data + model,
                                 "all-gather": 4 * bl * s * (tp - 1)}
        assert whole["wire"] == {"all-reduce": data}
        leaves = tree_leaves(tlm.param_schema(cfg, tp=tp), is_pspec)
        n_split = sum(1 for s_ in leaves if "model" in s_.pspec)
        assert split["comm"] == {
            "c10d.allreduce_": len(leaves) + 4 + 4 * layers + 2 + 4,
            "c10d.allgather_": 1,
            "c10d_functional.all_reduce": len(leaves) - n_split}
        assert whole["comm"][
            "c10d_functional.all_gather_into_tensor"] == n_split


# --------------------------------------------------------------------------- #
# No ranks: which leaves the split steps compute split, and the kv heads
# a rank's q heads read
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_specs_split_the_transformer_leaves_alone(arch):
    """Each leaf of the embedding and head, of every attention and MLP of
    a transformer block and of the shared experts keeps its layout; a
    routed expert stack keeps its layout under ``psum``/``a2a``; every
    other leaf (norms, router, Mamba-2, RWKV-6, zamba2's shared block,
    frontends) is whole."""
    cfg = get_config(arch, smoke=True)
    schema = tlm.param_schema(cfg, tp=4)
    specs = tlm._model_specs(cfg, schema)
    ep = cfg.moe is not None and cfg.moe.impl != "dense"
    split_keys = {"attn", "self_attn", "cross_attn", "mlp"}

    def walk(sch, sp, path):
        if is_pspec(sch):
            laid = (path[0] == "embed"
                    or (path[0].startswith("g") and (
                        path[1] in split_keys
                        or path[1:3] == ("moe", "shared")))
                    or (ep and sch.experts))
            assert sp == (P(*sch.pspec) if laid else P()), path
            return
        for k in sch:
            walk(sch[k], sp[k], path + (k,))

    walk(schema, specs, ())
    whole = tlm._model_specs(cfg, schema, split=False)
    assert all(s == P() or (ep and s_.experts) for s, s_ in zip(
        tree_leaves(whole, lambda x: isinstance(x, P)),
        tree_leaves(schema, is_pspec)))


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 4), (32, 4, 2), (32, 4, 8),
                                         (32, 4, 16), (12, 6, 4),
                                         (8, 2, 8)])
def test_each_rank_reads_the_kv_heads_of_its_q_heads(monkeypatch, heads, kv,
                                                     tp):
    """Where the q heads split and the kv heads do not, rank ``r``'s q
    head ``i`` reads whole kv head ``(r * heads / tp + i) // (heads /
    kv)`` after the usual repeat; a share that cuts a group (12 q heads
    over 4 ranks, groups of 2) gets one kv head a q head."""
    from repro_torch import shardmap

    cfg = get_config("yi-9b", smoke=True).with_(n_heads=heads,
                                                n_kv_heads=kv)
    hl = heads // tp
    k = torch.arange(kv, dtype=torch.float32).reshape(1, 1, kv, 1)
    for r in range(tp):
        monkeypatch.setattr(shardmap, "axis_index", lambda _a, r=r: r)
        kr, vr = tattn._rank_kv(k, k + 100, cfg, hl)
        got = tattn._repeat_kv(kr, hl // kr.shape[2])[0, 0, :, 0]
        want = [(r * hl + i) // (heads // kv) for i in range(hl)]
        assert got.tolist() == want
        assert (tattn._repeat_kv(vr, hl // vr.shape[2])[0, 0, :, 0]
                - 100).tolist() == want


def test_ctx_splits_only_in_a_split_step():
    """``Ctx.splits``: the yi-9b smoke's 4 q heads split over a model axis
    of 4 and its 2 kv heads do not, and nothing splits outside a split
    step."""
    cfg = get_config("yi-9b", smoke=True)
    mcfg = MeshConfig((2, 4), ("data", "model"))
    for split, want in ((False, (False, False)), (True, (True, False))):
        ctx = Ctx(cfg=cfg, mesh_cfg=mcfg, mode="train", split=split)
        assert (ctx.splits(cfg.n_heads), ctx.splits(cfg.n_kv_heads)) == want


def test_configs_are_the_references():
    """The variants' configs are the reference's field for field (the
    6-head internvl2-1b made by ``dataclasses.replace`` in both)."""
    import dataclasses

    for name in tr.TP_VARIANTS:
        a = dataclasses.asdict(tr._tp_cfg(get_config, name))
        b = dataclasses.asdict(tr._tp_cfg(j_get_config, name))
        assert a == b, name
