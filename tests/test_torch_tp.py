"""PyTorch port, the ``"model"`` split of the transformer, hybrid and
RWKV families' steps (``model/lm.py``: ``_model_specs``, the split train
step and ``Server(mesh=)``; ``layers.py``'s MLP, embedding and head,
``attention.py``'s heads, ``moe.py``'s shared experts, ``ssm.py``'s
Mamba-2 mixer, zamba2's shared block, ``rwkv.py``'s time-mix and
channel-mix, the vocabulary-parallel cross-entropy and
``shardmap.logsumexp``) against the reference's
XLA-partitioned steps on (2, 2) and (2, 4) meshes (the port as 4 and 8
``gloo`` ranks, the reference with 8 forced host devices:
``tests/torch_ranks.py``), from the reference's parameters, in f32:

* the yi-9b smoke (4 q heads, 2 kv heads: the kv heads split at a model
  axis of 2, replicated at 4, where each rank's q head reads the kv head
  of its group), also under ``scan_layers`` (the stacked leaves split one
  dim later) and on a batch masked unevenly over ``"data"`` (ROADMAP
  §C14), the internvl2-1b smoke with 6 q heads (its attention split at
  2, whole at 4, its MLP and tied vocabulary split at both), the
  zamba2-7b smoke (8 Mamba-2 heads, ``d_inner`` 128, a shared block of 4
  heads: all split at both), the rwkv6-7b smoke (4 heads of 16, ``d_ff``
  128: both mixers split at both) and the deepseek-moe-16b smoke (shared
  experts, a dense first layer) with each MoE impl;
* the loss and ``n_tok`` within 1e-5 (relative) and each gradient leaf
  within 1e-5 (relative rms) of the reference's and of the port's
  whole-step form, every rank gathering the same gradients; 3 steps of
  the mesh ``Trainer`` within 1e-4 of the reference's losses;
* ``Server(mesh=)``'s greedy tokens (prefill, then decode) equal to the
  reference's ``Server(mesh=)`` and to the port's meshless ``Server``,
  the rank's cache holding its data rank's rows of the pool where the
  data axes divide it (the whole pool where they do not), its kv heads
  where they split, its Mamba-2 heads and its RWKV-6 ``wkv`` heads; a
  data rank prefilling only its own slots' requests, on a pool built
  from zeros where none came in its first round (``tr.TP_SCENARIOS``);
  the ``psum`` and ``a2a`` MoE refusing a prefill over two data ranks as
  the reference's ``shard_map`` does, before any collective;
* the split step gathers no leaf over ``"model"`` (``CommDebugMode``
  sees no ``DTensor`` all-gather), and the helper's wire bytes are the
  sums the shapes call for: the activations' partial sums, the
  cross-entropy's, its row maxima and the gradients' reduction over
  ``"data"``.

The reference's jobs run side by side, then the port's two.
"""
import concurrent.futures
import dataclasses
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
from repro_torch.model import rwkv as trwkv
from repro_torch.model import ssm as tssm
from repro_torch.model.layers import (Ctx, init_params, is_pspec,
                                      shard_axis, tree_leaves)
from repro_torch.shardmap import P

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import get_config as j_get_config
    from repro.core.types import MeshConfig as JMeshConfig
    from repro.model import lm as jlm

MESHES = ("2x2", "2x4")
WORLD = {"2x2": 4, "2x4": 8}
CASES = [(v, m) for m in MESHES for v in tr.TP_VARIANTS]
SERVED = [(v, m) for m in MESHES for v in tr.TP_SERVED]
SCENARIOS = [(sc, m) for m in MESHES for sc in tr.TP_SCENARIOS]
REFUSED = [(v, m) for m in MESHES for v in tr.TP_REFUSED]
#: each scenario's slot of each request (queue order into free slots in
#: index order) and its exchanges over "data" where the data axes cut the
#: pool: one an admission round that admits, one a decode tick
SLOT_OF = {"refill": (0, 1, 1), "late": (0, 1), "whole": (0, 1, 2)}
EXCHANGES = {"refill": 2 + 4, "late": 2 + 3}
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
    for form in ("split", "whole"):
        assert abs(got[form]["n_tok"] - want["n_tok"]) <= 1e-5 * want["n_tok"]
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
    """Prefill then ``TP_NEW - 1`` decode ticks of two requests on two
    slots: the reference's ``Server(mesh=)``'s tokens and the meshless
    ``Server``'s, on every rank; the rank's cache holds its data rank's
    rows of the pool (2 slots over 2 data ranks: one row of every leaf),
    ``n_kv_heads / tp`` heads where they split over ``"model"``, all of
    them where they do not (zamba2's in its shared block's cache), a
    Mamba-2 layer's state the rank's ``H / tp`` heads and ``d_inner /
    tp`` conv channels, and an RWKV-6 layer's ``wkv`` state the rank's
    ``H / tp`` heads beside whole shift states; ``lm.pool_zeros`` gives
    that cache's shapes and dtypes."""
    ref, ports = runs
    cfg = _cfg(name)
    dp, tp = tr._tp_mesh(mesh)
    kv = cfg.n_kv_heads
    want = {"kv": kv // tp if shard_axis(kv, tp) else kv}
    if cfg.rwkv is not None:
        heads, _ = trwkv.rwkv_dims(cfg)
        want = {"wkv": heads // tp, "shift_att": cfg.d_model,
                "shift_ffn": cfg.d_model}
    if cfg.ssm is not None:
        d_inner, heads, _, _ = tssm.mamba_dims(cfg)
        want.update(ssm=heads // tp, conv_x=d_inner // tp)
    want["rows"] = [len(tr.TP_PROMPTS) // dp]
    for r in ports[mesh]:
        got = r[name]
        assert got["tokens"] == ref[mesh][name]["tokens"]
        assert got["meshless_tokens"] == got["tokens"]
        assert got["cache_heads"] == want
        assert got["pool_zeros"]
        assert all(len(t) == tr.TP_NEW for t in got["tokens"])


@pytest.mark.parametrize("scenario,mesh", SCENARIOS)
def test_server_scenarios_on_the_data_axes(runs, scenario, mesh):
    """The yi-9b smoke on ``tr.TP_SCENARIOS``: every rank's greedy tokens
    are the reference's ``Server(mesh=)``'s and the meshless
    ``Server``'s. Where the data axes divide the slots ("refill",
    "late") a rank holds ``slots / dp`` rows, prefills only the requests
    admitted into its data rank's slots (none in "refill"'s second round
    for data rank 0; none in "late"'s first round for data rank 1, which
    builds its pool from zeros and takes the late request into it) and
    gathers the last logits over "data" once an admitting round and once
    a tick; where they do not ("whole": 3 slots) every rank holds all 3
    rows, prefills every request and exchanges nothing. Every row of
    every pool stays finite."""
    ref, ports = runs
    dp, tp = tr._tp_mesh(mesh)
    slots, news, _ = tr.TP_SCENARIOS[scenario]
    want = ref[mesh]["yi"]["scenarios"][scenario]
    assert [len(t) for t in want] == list(news)
    split = slots % dp == 0
    k = slots // dp if split else slots
    for rank, r in enumerate(ports[mesh]):
        got = r["yi"]["scenarios"][scenario]
        assert got["tokens"] == want
        assert got["meshless"] == want
        assert got["rows"] == [k]
        assert got["finite"]
        d = rank // tp
        assert got["prefilled"] == [
            rid for rid, slot in enumerate(SLOT_OF[scenario])
            if not split or slot // k == d]
        assert got["exchanges"] == (EXCHANGES[scenario] if split else 0)


@pytest.mark.parametrize("name,mesh", REFUSED)
def test_moe_dispatch_over_data_refuses_a_prefill_as_the_reference(
        runs, name, mesh):
    """The deepseek-moe-16b smoke with ``psum`` and ``a2a`` through
    ``Server(mesh=)``: the reference's ``shard_map`` refuses to cut a
    prefill's batch of 1 over 2 data ranks (a ValueError); the port
    raises a ValueError on every rank before any collective (no wire
    bytes), so no rank waits on another."""
    ref, ports = runs
    kind, msg = ref[mesh][name]["refusal"]
    assert kind == "ValueError" and "not evenly divisible" in msg
    for r in ports[mesh]:
        kind, msg = r[name]["refusal"]
        assert kind == "ValueError"
        assert "cuts a prefill's batch of 1" in msg
        assert r[name]["refusal_wire"] == {}


@pytest.mark.parametrize("mesh", MESHES)
def test_unevenly_masked_batch_takes_the_whole_batch_ce(runs, mesh):
    """ROADMAP §C14: ``TP_MASKED`` targets of the first data shard masked,
    none of the other's. The split and the whole-step form count every
    unmasked target of the batch and take one CE sum over that count, as
    the reference's step; the mean of the two shards' means would be off
    by about 1e-2 of the loss here."""
    ref, ports = runs
    want = ref[mesh]["yi/uneven"]
    assert want["n_tok"] == tr.TP_B * tr.TP_S - tr.TP_MASKED
    shard = tr.TP_B // 2
    b = np.asarray(want["batch"]["targets"])
    assert [int((b[i * shard:(i + 1) * shard] < 0).sum()) for i in (0, 1)] \
        == [tr.TP_MASKED, 0]
    for r in ports[mesh]:
        for form in ("split", "whole"):
            got = r["yi/uneven"][form]
            assert got["n_tok"] == want["n_tok"]
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]


@pytest.mark.parametrize("mesh", MESHES)
def test_zamba2_split_holds_and_computes_its_blocks(runs, mesh):
    """The zamba2 smoke's split step: each rank holds its block of the
    Mamba-2 mixer's ``d_inner`` and heads and of the shared block's
    attention heads and MLP columns (``lm.model_blocks``), and no leaf is
    gathered over ``"model"`` (``CommDebugMode`` sees no ``DTensor``
    all-gather); the whole-step form gathers them."""
    _, ports = runs
    cfg = _cfg("zamba2")
    tp = _tp(mesh)
    d_inner, heads, _, _ = tssm.mamba_dims(cfg)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.hd
    want_mamba = {
        "w_z": (L, d, d_inner // tp), "w_x": (L, d, d_inner // tp),
        "conv_x": (L, 4, d_inner // tp), "norm_scale": (L, d_inner // tp),
        "w_dt": (L, d, heads // tp), "A_log": (L, heads // tp),
        "dt_bias": (L, heads // tp), "D": (L, heads // tp),
        "w_out": (L, d_inner // tp, d)}
    h = cfg.n_heads * hd // tp
    want_shared = {
        "attn": {"wq": (2 * d, h), "wk": (2 * d, h), "wv": (2 * d, h),
                 "wo": (h, 2 * d)},
        "mlp": {"w_gate": (2 * d, cfg.d_ff // tp),
                "w_up": (2 * d, cfg.d_ff // tp),
                "wo": (cfg.d_ff // tp, 2 * d)},
        "out_proj": (2 * d, d)}
    for r in ports[mesh]:
        got = r["zamba2"]
        mamba = got["blocks"]["g0"]["mamba"]
        for k, shape in want_mamba.items():
            assert mamba[k] == shape, k
        for k in ("w_B", "w_C"):
            assert mamba[k] == (L, d, cfg.ssm.d_state)
        shared = got["blocks"]["shared"]
        assert {k: shared[k] for k in want_shared} == want_shared
        assert got["split"]["gathers"] == 0
        assert got["whole"]["gathers"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_rwkv6_split_holds_and_computes_its_blocks(runs, mesh):
    """The rwkv6 smoke's split step: each rank holds its block of the
    time-mix's heads (``wr``/``wk``/``wv``/``wg``/``decay_w2``'s columns,
    ``decay``/``ln_x_*``/``u``'s blocks, ``wo``'s rows) and of the
    channel-mix's ``d_ff`` (``wk``'s columns, ``wv``'s rows), the
    token-shift mixes, ``decay_w1`` and the channel-mix's ``wr`` whole;
    its served ``wkv`` state holds ``H / tp`` heads; and no leaf is
    gathered over ``"model"``, where the whole-step form gathers them."""
    _, ports = runs
    cfg = _cfg("rwkv6")
    tp = _tp(mesh)
    heads, n = trwkv.rwkv_dims(cfg)
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    da = heads * n // tp
    lora = cfg.rwkv.decay_lora
    want_att = {
        "wr": (L, d, da), "wk": (L, d, da), "wv": (L, d, da),
        "wg": (L, d, da), "decay_w2": (L, lora, da), "decay": (L, da),
        "ln_x_scale": (L, da), "ln_x_bias": (L, da),
        "u": (L, heads // tp, n), "wo": (L, da, d),
        "maa_x": (L, d), "maa_wkvrg": (L, 5, d),
        "maa_w1": (L, d, 5 * trwkv.MIX_RANK),
        "maa_w2": (L, 5, trwkv.MIX_RANK, d), "decay_w1": (L, d, lora)}
    want_ffn = {"wk": (L, d, f // tp), "wv": (L, f // tp, d),
                "wr": (L, d, d), "maa_k": (L, d), "maa_r": (L, d)}
    for r in ports[mesh]:
        got = r["rwkv6"]
        assert got["blocks"]["g0"]["att"] == want_att
        assert got["blocks"]["g0"]["ffn"] == want_ffn
        assert got["cache_heads"]["wkv"] == heads // tp
        assert got["split"]["gathers"] == 0
        assert got["whole"]["gathers"] > 0


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
    ``"data"`` every gradient block, the 4 scalars of loss and metrics
    and the CE's count of unmasked targets (an int32, ROADMAP §C14). The whole-step form gathers each leaf split over
    ``"model"``."""
    _, ports = runs
    cfg = get_config("yi-9b", smoke=True)
    dp, tp = tr._tp_mesh(mesh)
    bl, s, d, layers = tr.TP_B // dp, tr.TP_S, cfg.d_model, cfg.n_layers
    ring_m = 2 * (tp - 1) / tp
    ring_d = 2 * (dp - 1) / dp
    for r in ports[mesh]:
        split, whole = r["counter"]["split"], r["counter"]["whole"]
        # the gradients, the loss and metrics, the CE's count of targets
        data = ring_d * (4 * split["grad_numel"] + 4 * 4 + 4)
        model = ring_m * 4 * (bl * s * d * (4 * layers + 2) + 4 * bl * s)
        assert split["wire"] == {"all-reduce": data + model,
                                 "all-gather": 4 * bl * s * (tp - 1)}
        assert whole["wire"] == {"all-reduce": data}
        leaves = tree_leaves(tlm.param_schema(cfg, tp=tp), is_pspec)
        n_split = sum(1 for s_ in leaves if "model" in s_.pspec)
        assert split["comm"] == {
            "c10d.allreduce_": len(leaves) + 4 + 1 + 4 * layers + 2 + 4,
            "c10d.allgather_": 1,
            "c10d_functional.all_reduce": len(leaves) - n_split}
        assert whole["comm"][
            "c10d_functional.all_gather_into_tensor"] == n_split


# --------------------------------------------------------------------------- #
# No ranks: which leaves the split steps compute split, the kv heads a
# rank's q heads read, and the serving pool's rows and zeros
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_specs_split_the_transformer_leaves_alone(arch):
    """Each leaf of the embedding and head, of every attention and MLP of
    a transformer block and of zamba2's shared block, of the shared
    experts, of a Mamba-2 mixer that splits (``ssm.mixer_splits``: the
    zamba2 smoke's at a model axis of 4), of an RWKV-6 time-mix that
    splits (``rwkv.time_mix_splits``: the rwkv6 smoke's at 4) and of
    every RWKV-6 channel-mix keeps its layout; a routed expert stack
    keeps its layout under ``psum``/``a2a``; every other leaf (norms,
    router, the shared block's ``out_proj``, frontends) is whole."""
    cfg = get_config(arch, smoke=True)
    schema = tlm.param_schema(cfg, tp=4)
    specs = tlm._model_specs(cfg, schema, 4)
    ep = cfg.moe is not None and cfg.moe.impl != "dense"
    split_keys = {"attn", "self_attn", "cross_attn", "mlp"}
    mamba = cfg.ssm is not None and tssm.mixer_splits(cfg, 4)
    assert mamba == (arch == "zamba2-7b")
    rwkv = cfg.rwkv is not None and trwkv.time_mix_splits(cfg, 4)
    assert rwkv == (arch == "rwkv6-7b")

    def walk(sch, sp, path):
        if is_pspec(sch):
            laid = (path[0] == "embed"
                    or (path[0].startswith("g") and (
                        path[1] in split_keys
                        or path[1:3] == ("moe", "shared")
                        or (path[1] == "mamba" and mamba)
                        or (path[1] in ("att", "ffn") and rwkv)))
                    or (path[0] == "shared" and path[1] in split_keys)
                    or (ep and sch.experts))
            assert sp == (P(*sch.pspec) if laid else P()), path
            return
        for k in sch:
            walk(sch[k], sp[k], path + (k,))

    walk(schema, specs, ())
    whole = tlm._model_specs(cfg, schema, 4, split=False)
    assert all(s == P() or (ep and s_.experts) for s, s_ in zip(
        tree_leaves(whole, lambda x: isinstance(x, P)),
        tree_leaves(schema, is_pspec)))


@pytest.mark.parametrize("tp,groups", [(16, 1), (32, 1), (2, 2)])
def test_mamba_mixer_is_whole_where_it_does_not_split(tp, groups):
    """The zamba2 smoke's mixer (8 heads, ``d_inner`` 128) at a model axis
    its heads do not divide (16: ``d_inner`` does, so ``w_z`` is laid
    over it; 32), or with B and C in two groups: every leaf of the mixer
    is whole in the split step, which then computes it whole on every
    rank; the shared block keeps its layout."""
    cfg = get_config("zamba2-7b", smoke=True)
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
    assert not tssm.mixer_splits(cfg, tp)
    schema = tlm.param_schema(cfg, tp=tp)
    specs = tlm._model_specs(cfg, schema, tp)
    assert all(s == P() for s in tree_leaves(
        specs["g0"]["mamba"], lambda x: isinstance(x, P)))
    if tp == 16:
        assert "model" in schema["g0"]["mamba"]["w_z"].pspec
    assert specs["shared"]["mlp"]["wo"] == P(
        *schema["shared"]["mlp"]["wo"].pspec)


def test_rwkv6_time_mix_is_whole_where_its_heads_do_not_split():
    """The rwkv6 smoke (4 heads of 16, ``d_ff`` 128) at a model axis of 8:
    ``da`` = 64 divides it, so ``wr`` is laid over it, but a rank's 8
    columns would cut a head, so every leaf of the time-mix is whole in
    the split step, which computes it whole on every rank (a block of
    the wrong width raises); the channel-mix's ``d_ff`` splits."""
    cfg = get_config("rwkv6-7b", smoke=True)
    assert not trwkv.time_mix_splits(cfg, 8)
    assert trwkv.time_mix_splits(cfg, 4)
    schema = tlm.param_schema(cfg, tp=8)
    assert "model" in schema["g0"]["att"]["wr"].pspec
    specs = tlm._model_specs(cfg, schema, 8)
    assert all(s == P() for s in tree_leaves(
        specs["g0"]["att"], lambda x: isinstance(x, P)))
    ffn = schema["g0"]["ffn"]
    assert specs["g0"]["ffn"]["wk"] == P(*ffn["wk"].pspec) != P()
    assert specs["g0"]["ffn"]["wv"] == P(*ffn["wv"].pspec) != P()
    assert "model" not in specs["g0"]["ffn"]["wr"]
    mcfg = MeshConfig((1, 8), ("data", "model"))
    ctx = Ctx(cfg=cfg, mesh_cfg=mcfg, mode="train", split=True)
    assert ctx.splits(cfg.d_ff)
    gen = torch.Generator().manual_seed(0)
    p = init_params(trwkv.rwkv_time_schema(cfg, 8), gen)
    x = torch.randn(1, 3, cfg.d_model, generator=gen)
    out, _ = trwkv.rwkv_time_mix(p, x, ctx)     # whole: no collective
    assert out.shape == x.shape
    half = dict(p, u=p["u"][:2], wr=p["wr"][:, :32])
    with pytest.raises(ValueError, match="heads this step computes"):
        trwkv.rwkv_time_mix(half, x, ctx)


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


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4), (2, 16, 16)])
@pytest.mark.parametrize("slots", [1, 2, 3, 4, 16])
def test_pool_rows_are_the_references_batch_layout(shape, slots):
    """``lm.pool_rows``: the data axes of the reference's
    ``_batch_axis`` (``pod`` major), where the pool is cut over them,
    with ``slots`` over their size rows a data rank; None where the
    reference keeps the batch whole."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    want = jlm._batch_axis(JMeshConfig(shape, axes), slots)
    got = tlm.pool_rows(MeshConfig(shape, axes), slots)
    if want is None:
        assert got is None
    else:
        assert got == (tuple(want), slots // int(np.prod(shape[:-1])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", tr.TP_SERVED)
def test_pool_zeros_has_a_padded_prefills_cache_leaves(name, dtype):
    """With no mesh, ``lm.pool_zeros`` of one slot is zeros of the shapes
    and dtypes of a prefill's cache padded to ``max_len``, for every
    served variant, in f32 and bf16."""
    from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
    from repro_torch.model.transformer import pad_cache

    cfg = _cfg(name)
    par = ParallelismConfig(compute_dtype=dtype)
    params = init_params(tlm.param_schema(cfg, tp=1),
                         torch.Generator().manual_seed(0))
    _, cache = tlm.make_prefill_step(cfg, SMOKE_MESH, par)(
        params, {"tokens": torch.tensor([tr.TP_PROMPTS[0]])})
    cache = tree_leaves(pad_cache(cache, 10))
    zeros = tree_leaves(tlm.pool_zeros(cfg, SMOKE_MESH, par, 1, 10, None,
                                       torch.device("cpu")))
    assert [(t.shape, t.dtype) for t in zeros] == [(t.shape, t.dtype)
                                                   for t in cache]
    assert all(not t.any() for t in zeros)


def test_configs_are_the_references():
    """The variants' configs are the reference's field for field (the
    6-head internvl2-1b made by ``dataclasses.replace`` in both)."""
    for name in tr.TP_VARIANTS:
        a = dataclasses.asdict(tr._tp_cfg(get_config, name))
        b = dataclasses.asdict(tr._tp_cfg(j_get_config, name))
        assert a == b, name
