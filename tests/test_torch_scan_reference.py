"""PyTorch port, scan-over-layers against the reference's scan path, on the
CPU in float32 at smoke size: the reference's ``tests/test_scan_unroll.py::
test_scan_decode_matches_unroll_full`` cells (``yi-9b``, ``zamba2-7b``,
``rwkv6-7b``, ``whisper-tiny``, ``deepseek-moe-16b``), with the reference's
``Stepper.init`` parameters carried across by ``convert.params_from_jax``.

* The port's scanned prefill cache has the reference's scanned prefill
  cache's structure (``{"g0": ..., "shared": ...}``, whisper's encoder
  group None), shapes and dtypes, and each leaf lies within 1e-5 of the
  reference's, relative to the leaf's largest magnitude.
* One scanned decode token over the padded stacked cache lies within 5e-3
  (max abs) of the port's unrolled forward over the whole sequence, the
  reference test's bar, and within 1e-5 of the reference's scanned decode.

One reference prefill and one reference decode an arch.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import types as jtypes
    from repro.model import lm as jlm

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
from repro_torch.model import lm as tlm
from test_torch_scan import pad_stacked

ARCHS = ["yi-9b", "zamba2-7b", "rwkv6-7b", "whisper-tiny", "deepseek-moe-16b"]
S, B = 16, 2
TOL = 1e-5


def _flat(tree, is_leaf, path=""):
    """{path: leaf} of nested dicts (sorted keys), tuples and lists."""
    if tree is None or is_leaf(tree):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], is_leaf, f"{path}/{k}"))
    else:
        for i, t in enumerate(tree):
            out.update(_flat(t, is_leaf, f"{path}/{i}"))
    return out


def _pad_stacked_jax(cache, target):
    """The reference test's ``_pad_stacked``."""
    def pad_group(g):
        if not (isinstance(g, dict) and "k" in g and "v" in g):
            return g
        out = dict(g)
        for key in ("k", "v"):
            buf = g[key]
            extra = target - buf.shape[2]
            if extra > 0:
                pad = [(0, 0)] * buf.ndim
                pad[2] = (0, extra)
                out[key] = jnp.pad(buf, pad)
        return out

    return {k: pad_group(v) if isinstance(v, dict) else v
            for k, v in cache.items()}


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_positions, cfg.frontend_dim)).astype(
                np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages' scanned prefill (S tokens) and scanned decode of
    token S over the cache padded to S + 4, and the port's unrolled
    forward over S + 1 tokens."""
    arch = request.param
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    jpar = jtypes.ParallelismConfig(compute_dtype="float32",
                                    scan_layers=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", S, B),
                     jtypes.SMOKE_MESH, jtypes.ParallelismConfig(
                         compute_dtype="float32"))
    jparams, _ = st.init(seed=5)
    tparams = to_torch(params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg), device="cpu")
    full = _batch(tcfg, S + 1, seed=9)
    pre = dict(full, tokens=full["tokens"][:, :S])
    nxt = full["tokens"][:, S:S + 1]

    _, jcache = jlm.make_prefill_step(jcfg, jtypes.SMOKE_MESH, jpar)(
        jparams, {k: jnp.asarray(v) for k, v in pre.items()})
    jlog, _ = jlm.make_decode_step(jcfg, jtypes.SMOKE_MESH, jpar)(
        jparams, jnp.asarray(nxt), _pad_stacked_jax(jcache, S + 4))

    tpar_u = ParallelismConfig(compute_dtype="float32")
    tpar_s = ParallelismConfig(compute_dtype="float32", scan_layers=True)
    as_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa
    with torch.no_grad():
        want, _ = tlm.make_prefill_step(tcfg, SMOKE_MESH, tpar_u)(
            tparams, as_t(full))
        _, tcache = tlm.make_prefill_step(tcfg, SMOKE_MESH, tpar_s)(
            tparams, as_t(pre))
        snapshot = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in _flat(tcache, torch.is_tensor).items()}
        tlog, _ = tlm.make_decode_step(tcfg, SMOKE_MESH, tpar_s)(
            tparams, torch.from_numpy(nxt), pad_stacked(tcache, S + 4))
    return {"jcache": jcache, "tcache": snapshot, "jlog": np.asarray(jlog),
            "tlog": tlog.numpy(), "full": want.numpy()}


def test_scanned_prefill_cache_is_the_references(run):
    j = _flat(run["jcache"], lambda a: isinstance(a, jax.Array))
    t = run["tcache"]
    assert sorted(t) == sorted(j)
    assert any(k.startswith("/g") and v is not None for k, v in t.items())
    for k, want in j.items():
        got = t[k]
        if want is None:
            assert got is None, k
            continue
        assert tuple(got.shape) == tuple(want.shape), k
        assert str(got.dtype).replace("torch.", "") == \
            jnp.dtype(want.dtype).name, k
        want = np.asarray(want, np.float64)
        err = float(np.abs(got.double().numpy() - want).max())
        assert err <= TOL * float(np.abs(want).max()), (k, err)


def test_scanned_decode_is_the_references(run):
    tlog = run["tlog"]
    assert float(np.abs(tlog - run["full"]).max()) < 5e-3
    assert float(np.abs(tlog - run["jlog"]).max()) <= TOL
