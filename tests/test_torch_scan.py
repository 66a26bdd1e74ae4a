"""PyTorch port, scan-over-layers (``ParallelismConfig.scan_layers``) on the
CPU in float32 at smoke size, against the port's own unrolled form and the
reference's layouts.

* Loss and gradients, scan against unrolled, for every LM arch: the loss
  within 1e-5 and every gradient leaf within 1e-3 of its largest
  magnitude, the bars of the reference's ``tests/test_scan_unroll.py``
  (the port's two forms run the same ops in the same order, so they are
  also asserted equal bit for bit); zamba2 and whisper also under each
  remat policy.
* Prefill, then decode over the padded stacked cache, for every LM arch:
  the stacked cache is the unrolled cache stacked by group, logits equal
  the unrolled ones, and the tick writes every leaf in place.
* ``model_cache_schema(stacked=True)`` equals the reference's in shapes
  and dtypes for every full and smoke config (metadata only).
* ``launch/train.py --scan`` takes the scan path, with the losses of the
  same run without it.

The reference's scanned prefill and decode, held against the port's, are
in ``tests/test_torch_scan_reference.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import types as jtypes
    from repro.model import layers as jlayers
    from repro.model import transformer as jtf

from repro_torch.configs import ALL_IDS, get_config
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.launch import train as tlaunch
from repro_torch.model import transformer as ttf
from repro_torch.model.layers import (is_pspec, tree_leaves, tree_map,
                                      value_and_grad)
from repro_torch.model.lm import (Stepper, make_decode_step, make_loss_fn,
                                  make_prefill_step)

ARCHS = [a for a in ALL_IDS if a not in ("elastic-lstm", "elastic-conv1d")]
S, B = 16, 2


def _pars(**kw):
    return (ParallelismConfig(compute_dtype="float32", **kw),
            ParallelismConfig(compute_dtype="float32", scan_layers=True,
                              **kw))


def _params(cfg, seed=0):
    return Stepper(cfg, ShapeConfig("t", "train", S, B), SMOKE_MESH,
                   _pars()[0]).init(seed, device="cpu")


def _batch(cfg, n, seed=1, train=True):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, n), generator=g)
    batch = {"tokens": tokens}
    if train:
        batch["targets"] = torch.randint(0, cfg.vocab_size, (B, n),
                                         generator=g)
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(B, cfg.n_frontend_tokens,
                                       cfg.frontend_dim, generator=g)
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(B, cfg.encoder.n_positions,
                                      cfg.frontend_dim, generator=g)
    return batch


def pad_stacked(cache, target: int):
    """``pad_cache`` for the stacked layout (the reference test's
    ``_pad_stacked``): K/V (L, B, S, KV, hd) padded on axis 2."""
    def pad_group(g):
        if not (isinstance(g, dict) and "k" in g and "v" in g):
            return g
        out = dict(g)
        for key in ("k", "v"):
            extra = target - g[key].shape[2]
            if extra > 0:
                out[key] = torch.nn.functional.pad(
                    g[key], (0, 0, 0, 0, 0, extra))
        return out

    return {k: pad_group(v) if isinstance(v, dict) else v
            for k, v in cache.items()}


def bf16_cross_kv(cache):
    """The unrolled cache with every decoder layer's cross K/V rounded to
    bf16, as the scan stacks them (the reference's scan does the same)."""
    return dict(cache, layers=tuple(
        dict(c, ck=c["ck"].to(torch.bfloat16), cv=c["cv"].to(torch.bfloat16))
        if isinstance(c, dict) and "ck" in c else c
        for c in cache["layers"]))


def stack_unrolled(cfg, cache):
    """The unrolled cache ``{"layers": ..., "shared": ...}`` stacked by
    group: the scan layout's expected content."""
    out, li = {}, 0
    cache = bf16_cross_kv(cache)
    for gi, (kind, count) in enumerate(ttf.group_structure(cfg)):
        entries = cache["layers"][li:li + count]
        li += count
        out[f"g{gi}"] = None if entries[0] is None else tree_map(
            lambda *ls: torch.stack(ls), *entries)
    if "shared" in cache:
        out["shared"] = tree_map(lambda *ls: torch.stack(ls),
                                 *cache["shared"])
    return out


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if w is None:
            assert g is None, k
            continue
        gl, wl = tree_leaves(g), tree_leaves(w)
        assert len(gl) == len(wl), k
        for a, b in zip(gl, wl):
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert torch.equal(a, b), k


# --------------------------------------------------------------------------- #
# Loss and gradients
# --------------------------------------------------------------------------- #


def _loss_and_grads(cfg, par, params, batch):
    (loss, _), grads = value_and_grad(make_loss_fn(cfg, SMOKE_MESH, par),
                                      has_aux=True)(params, batch)
    return loss, grads


def _hold(lu, gu, ls, gs):
    assert abs(float(lu) - float(ls)) < 1e-5
    for a, b in zip(tree_leaves(gu), tree_leaves(gs)):
        rel = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-3)
        assert rel < 1e-3
    assert torch.equal(lu, ls)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gu),
                                                 tree_leaves(gs)))


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_equals_unroll_train(arch):
    cfg = get_config(arch, smoke=True)
    par_u, par_s = _pars()
    params, batch = _params(cfg), _batch(cfg, S)
    lu, gu = _loss_and_grads(cfg, par_u, params, batch)
    ls, gs = _loss_and_grads(cfg, par_s, params, batch)
    _hold(lu, gu, ls, gs)
    assert len(tree_leaves(gs)) == len(tree_leaves(params))


@pytest.mark.parametrize("remat", ["dots", "none"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-tiny"])
def test_scan_equals_unroll_train_under_each_remat(arch, remat):
    """zamba2's scan remats a unit (6 Mamba-2 layers and the shared block
    at full size), whisper's encoder scan its body without the dots
    policy, as the reference does: other granularities, the same
    numbers."""
    cfg = get_config(arch, smoke=True).with_(remat=remat)
    par_u, par_s = _pars()
    params, batch = _params(cfg), _batch(cfg, S)
    _hold(*_loss_and_grads(cfg, par_u, params, batch),
          *_loss_and_grads(cfg, par_s, params, batch))


def test_hybrid_scan_checkpoints_whole_units(monkeypatch):
    """Under training remat the scan checkpoints each unit of
    ``shared_attn_every`` layers and the shared block once, and each
    remaining layer on its own (zamba2 smoke: 4 layers, every 2nd: two
    units, no remaining layer; with 5 layers one remaining layer)."""
    calls = []
    real = ttf.checkpoint

    def counting(fn, save_dots=False):
        run = real(fn, save_dots)

        def counted(*args):
            calls.append("unit" if fn.__name__ == "run_layers" else "layer")
            return run(*args)

        return counted

    monkeypatch.setattr(ttf, "checkpoint", counting)
    for n_layers, want in ((4, ["unit"] * 2),
                           (5, ["unit"] * 2 + ["layer"])):
        calls.clear()
        cfg = get_config("zamba2-7b", smoke=True).with_(n_layers=n_layers)
        _loss_and_grads(cfg, _pars()[1], _params(cfg), _batch(cfg, S))
        assert calls == want, (n_layers, calls)


# --------------------------------------------------------------------------- #
# Prefill and decode over the stacked cache
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_prefill_and_decode_equal_unroll(arch):
    """The scanned prefill's cache is the unrolled cache stacked by group
    (whisper's cross K/V in bf16, as the reference's scan stacks them);
    two ticks over the padded stacked cache give the unrolled ticks'
    logits and caches, and write into the given buffers (no leaf is a new
    tensor)."""
    cfg = get_config(arch, smoke=True)
    par_u, par_s = _pars()
    params = _params(cfg)
    full = _batch(cfg, S + 2, train=False)
    pre = dict(full, tokens=full["tokens"][:, :S])
    with torch.no_grad():
        lu, cu = make_prefill_step(cfg, SMOKE_MESH, par_u)(params, pre)
        ls, cs = make_prefill_step(cfg, SMOKE_MESH, par_s)(params, pre)
        assert torch.equal(lu, ls)
        _same(cs, stack_unrolled(cfg, cu))
        # whisper's decode then reads the same bf16 cross K/V on both paths
        cu, cs = ttf.pad_cache(bf16_cross_kv(cu), S + 4), pad_stacked(
            cs, S + 4)
        given = [t.data_ptr() for t in tree_leaves(cs)]
        dec_u = make_decode_step(cfg, SMOKE_MESH, par_u)
        dec_s = make_decode_step(cfg, SMOKE_MESH, par_s)
        for t in range(2):
            tok = full["tokens"][:, S + t:S + t + 1]
            lu, cu = dec_u(params, tok, cu)
            ls, cs = dec_s(params, tok, cs)
            assert torch.equal(lu, ls), t
            _same(cs, stack_unrolled(cfg, cu))
            assert [t.data_ptr() for t in tree_leaves(cs)] == given
        # and the scanned decode follows the scanned prefill: the next
        # token's logits of the full forward within the reference's bar
        want, _ = make_prefill_step(cfg, SMOKE_MESH, par_u)(
            params, dict(full, tokens=full["tokens"][:, :S + 2]))
    assert float((want - ls).abs().max()) < 5e-3


def test_scan_decode_positions_come_from_the_stacked_cache():
    """A tick reads its positions from the first attention group's (else
    the shared block's) stacked ``pos``, layer 0, as the reference's
    ``_decode_positions``; it copies them, since the tick writes each
    layer's new position into that buffer."""
    for arch, key in (("yi-9b", "g0"), ("deepseek-moe-16b", "g0"),
                      ("whisper-tiny", "g1"), ("zamba2-7b", "shared")):
        cfg = get_config(arch, smoke=True)
        cache = {key: {"pos": torch.tensor([[3, 5], [4, 6]],
                                           dtype=torch.int32)}}
        got = ttf._decode_positions(cfg, cache, 2, "cpu", stacked=True)
        assert got.tolist() == [3, 5]
        got += 1
        assert cache[key]["pos"][0].tolist() == [3, 5]
    got = ttf._decode_positions(get_config("rwkv6-7b", smoke=True),
                                {"g0": {}}, 2, "cpu", stacked=True)
    assert got.tolist() == [0, 0]


def test_scan_returns_no_cache_outside_serving():
    cfg = get_config("yi-9b", smoke=True)
    from repro_torch.model.layers import Ctx

    ctx = Ctx(cfg, SMOKE_MESH, "train", par=_pars()[1])
    out, cache, aux = ttf.apply_model(_params(cfg), _batch(cfg, S), ctx)
    assert cache is None and out.shape == (B, S, cfg.padded_vocab)
    assert float(aux) == 0.0


# --------------------------------------------------------------------------- #
# The stacked cache schema against the reference's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_cache_schema_equals_the_reference(arch, smoke):
    """Keys, shapes and dtypes of ``model_cache_schema(stacked=True)``
    (and of the unrolled layout beside it) equal the reference's at the
    arch's decode cell and at a small one."""
    tcfg = get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    for batch, seq in ((3, 40), (128, 32_768)):
        for stacked in (True, False):
            t = ttf.model_cache_schema(tcfg, batch, seq, SMOKE_MESH,
                                       stacked=stacked)
            j = jtf.model_cache_schema(jcfg, batch, seq, jtypes.SMOKE_MESH,
                                       stacked=stacked)
            assert sorted(t) == sorted(j)
            for k in j:
                if j[k] is None:
                    assert t[k] is None
                    continue
                tl = tree_leaves(t[k], is_pspec)
                jl = jax.tree.leaves(j[k], is_leaf=jlayers.is_pspec)
                assert [(s.shape, str(s.dtype).replace("torch.", ""))
                        for s in tl] == [
                    (tuple(s.shape), jnp.dtype(s.dtype).name)
                    for s in jl], (k, batch, stacked)
            if stacked:
                n = {f"g{gi}": c for gi, (_, c) in
                     enumerate(ttf.group_structure(tcfg))}
                n["shared"] = len(tcfg.shared_attn_points())
                for k, sub in t.items():
                    for s in tree_leaves(sub, is_pspec):
                        assert s.shape[0] == n[k] and s.pspec[0] is None


def test_stepper_cache_schema_follows_scan_layers():
    cfg = get_config("zamba2-7b", smoke=True)
    shape = ShapeConfig("d", "decode", 40, 3)
    par_u, par_s = _pars()
    assert set(Stepper(cfg, shape, SMOKE_MESH, par_u).cache_schema()) == {
        "layers", "shared"}
    st = Stepper(cfg, shape, SMOKE_MESH, par_s)
    assert set(st.cache_schema()) == {"g0", "shared"}
    cache = st.abstract_inputs()["cache"]
    assert cache["g0"]["ssm"].device.type == "meta"
    assert cache["shared"]["k"].shape == (2, 3, 40, cfg.n_kv_heads, cfg.hd)


# --------------------------------------------------------------------------- #
# launch/train.py --scan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["stablelm-3b", "zamba2-7b"])
def test_train_launcher_scan_takes_the_scan_path(arch, tmp_path,
                                                 monkeypatch):
    """``--scan`` sets ``ParallelismConfig(scan_layers=True)``: every step
    runs the layer loop with ``scan_layers`` set, and the logged losses
    equal those of the same run without ``--scan``, bit for bit."""
    seen = []
    real = ttf._runs

    def spy(cfg, ctx, n):
        seen.append((ctx.mode, ctx.par.scan_layers))
        return real(cfg, ctx, n)

    monkeypatch.setattr(ttf, "_runs", spy)
    losses = {}
    for scan in (True, False):
        argv = ["--arch", arch, "--steps", "3", "--seq", "16", "--batch",
                "2", "--device", "cpu", "--ckpt-dir",
                str(tmp_path / f"scan{scan}")] + (["--scan"] if scan else [])
        args = tlaunch.parse_args(argv)
        assert args.scan is scan
        out = tlaunch.run(args)
        losses[scan] = [m["loss"] for m in out["metrics"]]
        assert seen and set(seen) == {("train", scan)}
        seen.clear()
    assert len(losses[True]) == 2 and losses[True] == losses[False]
