"""PyTorch port, the LM families beyond dense: the configs (field for field
the reference's), the vision and audio frontends, cross- and non-causal
attention, the whole model's prefill and a decode step for each of the six
configs this slice adds (``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``,
``internvl2-1b``, ``whisper-tiny``, ``qwen3-32b``, ``stablelm-12b``) under
``ref`` and ``flash``, the schemas, the conversion of their trees, the
registry and ``active_param_count``, each against the JAX package, with
the reference's parameters carried across by ``convert.params_from_jax``.
All in float32 on the CPU, on the smoke configs.

Tolerance: 1e-5 absolute on every activation, logit and cache entry. The
two packages run the same float32 arithmetic in other summation orders,
which moves values of order 1 by a few 1e-7; nothing is looser.
"""
import contextlib
import dataclasses
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import registry as jregistry
    from repro.core import types as jtypes
    from repro.model import attention as jattn
    from repro.model import frontend as jfe
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import registry as tregistry
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.launch import serve as tserve
from repro_torch.model import attention as tattn
from repro_torch.model import frontend as tfe
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model import transformer as ttf
from repro_torch.runtime import server as tserver

NEW = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "internvl2-1b",
       "whisper-tiny", "qwen3-32b", "stablelm-12b")
IMPLS = ("ref", "flash")
TOL = 1e-5


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


def _ctxs(tcfg, jcfg, mode, impl="ref", positions=None):
    tpos = None if positions is None else torch.from_numpy(positions)
    jpos = None if positions is None else jnp.asarray(positions)
    tctx = tlayers.Ctx(tcfg, SMOKE_MESH, mode,
                       par=ParallelismConfig(compute_dtype="float32",
                                             attn_impl=impl),
                       positions=tpos, attn_impl=impl)
    jctx = jlayers.Ctx(jcfg, jtypes.SMOKE_MESH, mode,
                       par=jtypes.ParallelismConfig(
                           compute_dtype="float32", attn_impl=impl),
                       positions=jpos, attn_impl=impl)
    return tctx, jctx


@pytest.fixture(scope="module", params=NEW)
def model(request):
    """(port cfg, JAX cfg, port params on the CPU, JAX params) for one
    smoke config, the params drawn by the reference's Stepper.init."""
    arch = request.param
    jcfg = jconfigs.get_config(arch, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jparams, _ = st.init(seed=3)
    tcfg = get_config(arch, smoke=True)
    tparams = to_torch(params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tcfg), device="cpu")
    return tcfg, jcfg, tparams, jparams


def _batches(cfg, rng, B, S):
    """(port batch, JAX batch): tokens, plus the frontend's stub
    embeddings (patches or frames) where the config has one."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_positions, cfg.frontend_dim)).astype(
                np.float32)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


# --------------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_config_equals_reference_field_for_field(arch, smoke):
    t = dataclasses.asdict(get_config(arch, smoke=smoke))
    j = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
    assert {k: j[k] for k in t} == t
    # what the port leaves out is unset in the reference too
    assert all(j[k] in (None, 0, False) for k in set(j) - set(t)), \
        sorted(set(j) - set(t))


def test_arch_ids_and_all_configs():
    later = set()                 # every arch of the reference is ported
    assert tconfigs.ARCH_IDS == tuple(a for a in jconfigs.ARCH_IDS
                                      if a not in later)
    assert tconfigs.ALL_IDS == tuple(a for a in jconfigs.ALL_IDS
                                     if a not in later)
    for smoke in (False, True):
        cfgs = tconfigs.all_configs(smoke=smoke)
        assert tuple(cfgs) == tconfigs.ALL_IDS
        assert all(c.family in ("dense", "moe", "audio", "vlm", "hybrid",
                                "ssm", "lstm", "conv1d")
                   for c in cfgs.values())
    for a in later:
        with pytest.raises(KeyError, match="not ported"):
            get_config(a)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", NEW)
def test_block_kinds_and_active_param_count(arch):
    for smoke in (False, True):
        t, j = get_config(arch, smoke=smoke), jconfigs.get_config(
            arch, smoke=smoke)
        assert t.block_kinds() == j.block_kinds()
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_deepseek_full_size_counts():
    cfg = get_config("deepseek-moe-16b")
    assert cfg.param_count() == 16_375_728_128
    assert cfg.active_param_count() == 16_375_728_128 - (64 - 6) * 3 * \
        2048 * 1408 * 27


# --------------------------------------------------------------------------- #
# Frontends and attention
# --------------------------------------------------------------------------- #


def test_project_vision_against_reference():
    tcfg = get_config("internvl2-1b", smoke=True)
    jcfg = jconfigs.get_config("internvl2-1b", smoke=True)
    rng = np.random.default_rng(0)
    p = tlayers.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.3,
        tfe.frontend_schema(tcfg), is_leaf=tlayers.is_pspec)
    x = (rng.standard_normal((2, 8, tcfg.frontend_dim)) * 3 + 1).astype(
        np.float32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill")
    _close(tfe.project_vision(tlayers.tree_map(torch.from_numpy, p),
                              torch.from_numpy(x), tctx),
           jfe.project_vision(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jctx))


@pytest.mark.parametrize("n_frames", [16, 9])
def test_embed_audio_against_reference(n_frames):
    tcfg = get_config("whisper-tiny", smoke=True)
    jcfg = jconfigs.get_config("whisper-tiny", smoke=True)
    rng = np.random.default_rng(1)
    p = tlayers.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.3,
        tfe.frontend_schema(tcfg), is_leaf=tlayers.is_pspec)
    assert sorted(p) == ["in_proj", "pos_emb"]
    x = rng.standard_normal((2, n_frames, tcfg.frontend_dim)).astype(
        np.float32)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill")
    _close(tfe.embed_audio(tlayers.tree_map(torch.from_numpy, p),
                           torch.from_numpy(x), tctx),
           jfe.embed_audio(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jctx))


def test_frontend_schema_matches_reference():
    for arch in ("internvl2-1b", "whisper-tiny", "yi-9b"):
        t = tfe.frontend_schema(get_config(arch, smoke=True))
        j = jfe.frontend_schema(jconfigs.get_config(arch, smoke=True))
        assert {k: s.shape for k, s in t.items()} == {
            k: s.shape for k, s in j.items()}
        assert {k: s.init for k, s in t.items()} == {
            k: s.init for k, s in j.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen3-moe-30b-a3b"])
def test_cross_attention_against_reference(arch, mode):
    """Cross K/V (more positions than queries, GQA where the config has
    it, qk-norm on q only for qwen3): no RoPE, no cache, no mask."""
    tcfg = get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    rng = np.random.default_rng(2)
    p = tlayers.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2 + (
            1.0 if s.init == "ones" else 0.0)).astype(np.float32),
        tattn.attn_schema(tcfg, cross=True), is_leaf=tlayers.is_pspec)
    S = 1 if mode == "decode" else 5
    h = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, 11, tcfg.n_kv_heads, tcfg.hd)).astype(
        np.float32) for _ in range(2)]
    pos = np.full((2, S), 7, np.int32)
    for impl in IMPLS:
        tctx, jctx = _ctxs(tcfg, jcfg, mode, impl, pos)
        t_out, t_cache = tattn.attn_apply(
            tlayers.tree_map(torch.from_numpy, p), torch.from_numpy(h), tctx,
            cross_kv=tuple(map(torch.from_numpy, kv)))
        j_out, j_cache = jattn.attn_apply(
            jax.tree.map(jnp.asarray, p), jnp.asarray(h), jctx,
            cross_kv=tuple(map(jnp.asarray, kv)))
        _close(t_out, j_out)
        assert t_cache is None and j_cache is None


@pytest.mark.parametrize("impl", IMPLS)
def test_non_causal_self_attention_against_reference(impl, monkeypatch):
    """The encoder's self-attention (causal=False) in prefill: plain in
    both packages under either impl, over the full block and (thresholds
    shrunk) the q-chunked path; its prefill cache as the reference's."""
    tcfg = get_config("whisper-tiny", smoke=True)
    jcfg = jconfigs.get_config("whisper-tiny", smoke=True)
    rng = np.random.default_rng(3)
    p = tlayers.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        tattn.attn_schema(tcfg), is_leaf=tlayers.is_pspec)
    for S in (6, 13):
        if S == 13:
            for mod in (tattn, jattn):
                monkeypatch.setattr(mod, "FULL_ATTN_MAX_SEQ", 8)
                monkeypatch.setattr(mod, "Q_CHUNK", 4)
        h = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
        tctx, jctx = _ctxs(tcfg, jcfg, "prefill", impl, pos)
        t_out, t_c = tattn.attn_apply(tlayers.tree_map(torch.from_numpy, p),
                                      torch.from_numpy(h), tctx,
                                      causal=False)
        j_out, j_c = jattn.attn_apply(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(h), jctx, causal=False)
        _close(t_out, j_out)
        for key in ("k", "v", "pos"):
            _close(t_c[key], j_c[key])


# --------------------------------------------------------------------------- #
# The families through apply_model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_model_prefill_then_decode(model, impl):
    """Prefill logits, aux and every cache leaf, then one decode step over
    the caches padded by ``pad_cache`` (the reference's own
    decode-equivalence check, plus parity)."""
    tcfg, jcfg, tp, jp = model
    rng = np.random.default_rng(4)
    B, S, S_max = 2, 12, 20
    tb, jb = _batches(tcfg, rng, B, S)
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill", impl)
    t_logits, t_cache, t_aux = ttf.apply_model(tp, tb, tctx)
    j_logits, j_cache, j_aux = jtf.apply_model(jp, jb, jctx)
    _close(t_logits, j_logits)
    assert abs(float(t_aux) - float(j_aux)) <= 1e-6 * max(abs(float(j_aux)),
                                                          1e-30)
    tleaves = tlayers.tree_leaves(t_cache)
    jleaves = jax.tree.leaves(j_cache)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        _close(t, j)
    t_pad, j_pad = ttf.pad_cache(t_cache, S_max), jtf.pad_cache(j_cache,
                                                                S_max)
    for tc, c in zip(t_pad["layers"], t_cache["layers"]):
        if tc is not None and "ck" in tc:       # cross K/V kept as they are
            assert tc["ck"] is c["ck"] and tc["cv"] is c["cv"]
    nxt = rng.integers(0, tcfg.vocab_size, (B, 1))
    t_dec, t_new = tlm.make_decode_step(tcfg, SMOKE_MESH, tctx.par)(
        tp, torch.from_numpy(nxt), t_pad)
    j_dec, j_new = jlm.make_decode_step(jcfg, jtypes.SMOKE_MESH, jctx.par)(
        jp, jnp.asarray(nxt, jnp.int32), j_pad)
    _close(t_dec, j_dec)
    for t, j in zip(tlayers.tree_leaves(t_new), jax.tree.leaves(j_new)):
        _close(t, j)
    # the decode step's logits are the full sequence's last position
    full = {k: v for k, v in tb.items()}
    full["tokens"] = torch.cat([tb["tokens"], torch.from_numpy(nxt).int()],
                               dim=1)
    ref_logits, _, _ = ttf.apply_model(tp, full, dataclasses.replace(
        tctx, positions=None))
    _close(t_dec, ref_logits[:, -1], 1e-4)


def test_whisper_needs_frames_or_a_cache():
    cfg = get_config("whisper-tiny", smoke=True)
    jcfg = jconfigs.get_config("whisper-tiny", smoke=True)
    tctx, jctx = _ctxs(cfg, jcfg, "prefill")
    params = tlm.Stepper(cfg, ShapeConfig("p", "prefill", 8, 1), SMOKE_MESH,
                         tctx.par).init(seed=0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs frames or cache"):
        ttf.apply_model(params, {"tokens": tokens}, tctx)
    srv = tserver.Server(cfg, params, tserver.ServerConfig(
        batch_slots=1, max_len=16), SMOKE_MESH, tctx.par, device="cpu")
    srv.submit([3, 4, 5], max_new_tokens=2)
    with pytest.raises(ValueError, match="needs frames or cache"):
        srv.run_until_drained()


def test_vlm_without_patches_is_a_text_model():
    """A VLM batch without patches embeds tokens only, as the reference's
    Server serves it."""
    tcfg = get_config("internvl2-1b", smoke=True)
    jcfg = jconfigs.get_config("internvl2-1b", smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jp, _ = st.init(seed=2)
    tp = to_torch(params_from_jax(jax.tree.map(np.asarray, jp), tcfg),
                  device="cpu")
    tokens = np.random.default_rng(6).integers(0, 512, (1, 5))
    tctx, jctx = _ctxs(tcfg, jcfg, "prefill")
    _close(ttf.apply_model(tp, {"tokens": torch.from_numpy(tokens)},
                           tctx)[0],
           jtf.apply_model(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                           jctx)[0])


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_training_loss_of_the_encoder_decoder(remat):
    """Whisper's loss (encoder over frames, decoder over tokens) and its
    gradients under each remat policy against the reference."""
    tcfg = get_config("whisper-tiny", smoke=True).with_(remat=remat)
    jcfg = jconfigs.get_config("whisper-tiny", smoke=True).with_(remat=remat)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("t", "train", 8, 2),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jp, _ = st.init(seed=4)
    tp = to_torch(params_from_jax(jax.tree.map(np.asarray, jp), tcfg),
                  device="cpu")
    rng = np.random.default_rng(8)
    tb, jb = _batches(tcfg, rng, 2, 8)
    targets = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    tb["targets"], jb["targets"] = torch.from_numpy(targets), jnp.asarray(
        targets)
    jfn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH,
                           jtypes.ParallelismConfig(compute_dtype="float32"),
                           None)
    (jl, _), jg = jax.value_and_grad(jfn, has_aux=True)(jp, jb)
    tfn = tlm.make_loss_fn(tcfg, SMOKE_MESH,
                           ParallelismConfig(compute_dtype="float32"))
    (tl, _), tg = tlayers.value_and_grad(tfn, has_aux=True)(tp, tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for t, j in zip(tlayers.tree_leaves(tg), jax.tree.leaves(jg)):
        _close(t, j)
    assert float(tg["frontend"]["in_proj"].abs().max()) > 0


# --------------------------------------------------------------------------- #
# Schema, conversion, registry, launcher
# --------------------------------------------------------------------------- #


def test_schema_matches_reference_leaf_for_leaf(model):
    tcfg, jcfg, _, _ = model
    for port, ref in ((ttf.param_schema(tcfg), jtf.param_schema(jcfg, tp=1)),
                      (ttf.model_cache_schema(tcfg, 3, 40),
                       jtf.model_cache_schema(jcfg, 3, 40, jtypes.SMOKE_MESH,
                                              tp=1))):
        tl = tlayers.tree_leaves(port, tlayers.is_pspec)
        jl = jax.tree.leaves(ref, is_leaf=jlayers.is_pspec)
        assert [s.shape for s in tl] == [s.shape for s in jl]
        assert [str(s.dtype).split(".")[-1] for s in tl] == [
            str(np.dtype(s.dtype)) for s in jl]
    tl = tlayers.tree_leaves(ttf.param_schema(tcfg), tlayers.is_pspec)
    jl = jax.tree.leaves(jtf.param_schema(jcfg, tp=1),
                         is_leaf=jlayers.is_pspec)
    assert [s.init for s in tl] == [s.init for s in jl]
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", kind, 40, 3)
        jspecs = jlm.input_specs(jcfg, jtypes.ShapeConfig("s", kind, 40, 3))
        assert {k: v[0] for k, v in tlm.input_specs(tcfg, shape).items()} \
            == {k: v.shape for k, v in jspecs.items()}


def test_params_from_jax_round_trips_the_new_trees(model):
    tcfg, _, tp, jp = model
    jleaves = jax.tree.leaves(jp)
    tleaves = tlayers.tree_leaves(tp)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(j))
    back = params_from_jax(tlayers.tree_map(lambda t: t.numpy(), tp), tcfg)
    for t, b in zip(tleaves, tlayers.tree_leaves(back)):
        assert np.array_equal(t.numpy(), b)
    for key in ("frontend", "enc_norm"):
        assert (key in tp) == (key in jp)


@pytest.mark.parametrize("where", [
    ("deepseek-moe-16b", ("g1", "moe", "router"), "routerr"),
    ("deepseek-moe-16b", ("g1", "moe", "shared", "wo"), "w_out"),
    ("internvl2-1b", ("frontend", "w1"), "w_1"),
    ("whisper-tiny", ("g1", "cross_attn", "wk"), "w_k"),
    ("whisper-tiny", ("enc_norm", "scale"), "scales")])
def test_params_from_jax_rejects_a_wrong_key_with_its_path(where):
    arch, path, wrong = where
    cfg = get_config(arch, smoke=True)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        jtf.param_schema(jconfigs.get_config(
                            arch, smoke=True), tp=1),
                        is_leaf=jlayers.is_pspec)
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[wrong] = node.pop(path[-1])
    where_ = "".join(f"\\['{k}'\\]" for k in path[:-1])
    with pytest.raises(KeyError, match=rf"params{where_}: missing keys "
                                       rf"\['{path[-1]}'\], unexpected keys "
                                       rf"\['{wrong}'\]"):
        params_from_jax(tree, cfg)
    node[path[-1]] = node.pop(wrong)[:1]        # and a wrong shape
    with pytest.raises(ValueError, match=rf"params{where_}\['{path[-1]}'\]: "
                                         "shape"):
        params_from_jax(tree, cfg)


@pytest.mark.parametrize("arch", NEW)
def test_validate_config_accepts_the_new_configs(arch):
    for smoke in (False, True):
        got = tregistry.validate_config(get_config(arch, smoke=smoke))
        want = jregistry.validate_config(jconfigs.get_config(arch,
                                                             smoke=smoke))
        assert sorted(got) == sorted(want)
        for name, comp in got.items():
            assert comp.ref.startswith("repro_torch."), comp.ref
            assert comp.ref.replace("repro_torch.", "repro.") == \
                want[name].ref


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b",
                                  "internvl2-1b"])
def test_serve_launcher_runs_the_new_arch_on_the_cpu(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", arch, "--device", "cpu", "--requests",
                          "3", "--slots", "2", "--max-new", "3"])
    lines = buf.getvalue().splitlines()
    assert rc == 0
    assert sum(ln.startswith("req ") for ln in lines) == 3
    assert "3 requests, 9 tokens" in lines[-1]
