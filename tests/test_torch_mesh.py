"""PyTorch port, the mesh layouts: every leaf's layout (``PSpec.pspec``)
against the reference's partition spec, and every leaf's block on a
``torch.distributed`` device mesh against the reference's shard shape.
Metadata only: no collective runs and no tensor is split.

* ``param_schema(cfg, tp)`` at tp 16 and 1, every config at full size:
  each leaf's layout equals ``tuple(P)`` of the reference's.
* ``model_cache_schema`` (unrolled and stacked, ``seq_shard`` on and off)
  at ``SINGLE_POD`` and ``MULTI_POD`` for every cell of ``shapes_for``,
  and ``batch_pspecs`` for every (arch, shape): the same.
* ``abstract_params``: ``meta`` tensors of the reference's shapes and
  dtypes, with and without ``dtype_override``.
* In one subprocess, fake process groups of 256 and then 512 ranks build
  ``make_production_mesh``; every leaf's local shape under ``shardings``
  (params, caches, inputs) equals ``NamedSharding(mesh, P).shard_shape``
  of the reference's spec, computed here on a JAX ``AbstractMesh`` of the
  same shape; on an 8-rank (2, 4) mesh every coordinate's block and
  offset cut an uneven tensor as ``torch.chunk`` does.
* Without a process group ``make_production_mesh`` raises.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import types as jtypes
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import transformer as jtf

from repro_torch.configs import ALL_IDS, get_config
from repro_torch.core import types as ttypes
from repro_torch.launch import mesh as tmesh
from repro_torch.model import layers as tlayers
from repro_torch.model import lm as tlm
from repro_torch.model import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ALL_IDS if a not in ("elastic-lstm", "elastic-conv1d")]
MESHES = {"single": (ttypes.SINGLE_POD, jtypes.SINGLE_POD),
          "multi": (ttypes.MULTI_POD, jtypes.MULTI_POD)}


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


def _dtype(dt) -> str:
    return (str(dt).replace("torch.", "") if isinstance(dt, torch.dtype)
            else jnp.dtype(dt).name)


def _layouts(t_schema, j_schema):
    """{path: (shape, dtype, layout)} of both schemas."""
    t = {k: None if s is None else (tuple(s.shape), _dtype(s.dtype),
                                    s.pspec)
         for k, s in _flat(t_schema, tlayers.is_pspec).items()}
    j = {k: None if s is None else (tuple(s.shape), _dtype(s.dtype),
                                    tuple(s.pspec))
         for k, s in _flat(j_schema, jlayers.is_pspec).items()}
    return t, j


def _equal_layouts(t_schema, j_schema, what):
    t, j = _layouts(t_schema, j_schema)
    assert sorted(t) == sorted(j), what
    for k in j:
        assert t[k] == j[k], (what, k, t[k], j[k])
    return len(j)


@pytest.mark.parametrize("tp", [16, 1])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_layouts_equal_the_reference(arch, tp):
    n = _equal_layouts(ttf.param_schema(get_config(arch), tp=tp),
                       jtf.param_schema(jconfigs.get_config(arch), tp=tp),
                       (arch, tp))
    assert n > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_layouts_equal_the_reference(arch, mesh):
    tcfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    tmc, jmc = MESHES[mesh]
    tp = tmc.axis_size("model")
    sharded = 0
    for name in ttypes.shapes_for(tcfg):
        shape = ttypes.SHAPES[name]
        for stacked in (False, True):
            for seq_shard in (False, True):
                what = (arch, mesh, name, stacked, seq_shard)
                t = ttf.model_cache_schema(
                    tcfg, shape.global_batch, shape.seq_len, tmc, tp=tp,
                    stacked=stacked, seq_shard=seq_shard)
                _equal_layouts(t, jtf.model_cache_schema(
                    jcfg, shape.global_batch, shape.seq_len, jmc, tp=tp,
                    stacked=stacked, seq_shard=seq_shard), what)
                sharded += sum(any(e is not None for e in s.pspec)
                               for s in tlayers.tree_leaves(
                                   t, tlayers.is_pspec))
    assert sharded > 0


def test_stepper_layouts_follow_the_mesh_config():
    """``Stepper`` reads tp from its ``MeshConfig`` (the reference's
    ``axis_size("model")``), and its cache layout follows
    ``seq_shard_decode`` and ``scan_layers``."""
    cfg, jcfg = get_config("yi-9b"), jconfigs.get_config("yi-9b")
    shape = ttypes.SHAPES["decode_32k"]
    for par_kw in ({}, {"seq_shard_decode": True},
                   {"scan_layers": True, "seq_shard_decode": True}):
        st = tlm.Stepper(cfg, shape, ttypes.SINGLE_POD,
                         ttypes.ParallelismConfig(**par_kw))
        jst = jlm.Stepper(jcfg, jtypes.SHAPES["decode_32k"],
                          jtypes.SINGLE_POD,
                          jtypes.ParallelismConfig(**par_kw))
        _equal_layouts(st.schema, jst.schema, par_kw)
        _equal_layouts(st.cache_schema(), jst.cache_schema(), par_kw)
        assert tlayers.tree_leaves(
                st.param_pspecs, lambda x: isinstance(x, tuple)) == [
            tuple(p) for p in jax.tree.leaves(
                jst.param_pspecs, is_leaf=lambda x: isinstance(x, P))]
    with pytest.raises(ValueError, match="needs a mesh"):
        st.shardings(st.schema)


@pytest.mark.parametrize("mesh", ["single", "multi", "smoke"])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_batch_layouts_equal_the_reference(arch, mesh):
    tmc, jmc = MESHES.get(mesh, (ttypes.SMOKE_MESH, jtypes.SMOKE_MESH))
    tcfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    table = ttypes.shape_table_for(tcfg)
    jtable = jtypes.shape_table_for(jcfg)
    for name in ttypes.shapes_for(tcfg):
        t = tlm.batch_pspecs(tcfg, table[name], tmc)
        j = jlm.batch_pspecs(jcfg, jtable[name], jmc)
        assert t == {k: tuple(v) for k, v in j.items()}, (arch, name)
        assert sorted(t) == sorted(tlm.input_specs(tcfg, table[name]))
        assert tlm._batch_axis(tmc, table[name].global_batch) == \
            jlm._batch_axis(jmc, jtable[name].global_batch)


@pytest.mark.parametrize("override", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_abstract_params_are_the_references(arch, override):
    t = tlayers.abstract_params(
        ttf.param_schema(get_config(arch)),
        dtype_override=override and getattr(torch, override))
    j = jlayers.abstract_params(
        jtf.param_schema(jconfigs.get_config(arch)),
        dtype_override=override and jnp.dtype(override))
    tf_, jf = _flat(t, torch.is_tensor), _flat(
        j, lambda a: isinstance(a, jax.ShapeDtypeStruct))
    assert sorted(tf_) == sorted(jf)
    for k, s in jf.items():
        got = tf_[k]
        assert got.device.type == "meta"
        assert (tuple(got.shape), _dtype(got.dtype)) == (
            tuple(s.shape), _dtype(s.dtype)), k


def test_stepper_abstract_inputs():
    """Params and the batch (and the optimizer state in training, the
    cache in decode) as ``meta`` tensors of the reference's shapes."""
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = ttypes.SHAPES[name]
        st = tlm.Stepper(get_config("deepseek-moe-16b"), shape,
                         ttypes.SINGLE_POD, ttypes.ParallelismConfig())
        out = st.abstract_inputs()
        want = {"train": {"params", "opt_state", "batch"},
                "prefill": {"params", "batch"},
                "decode": {"params", "batch", "cache"}}[shape.kind]
        assert set(out) == want
        leaves = tlayers.tree_leaves(out)
        assert leaves and all(t.device.type == "meta" for t in leaves)
        for k, (shp, dt) in tlm.input_specs(st.cfg, shape).items():
            assert out["batch"][k].shape == shp and \
                out["batch"][k].dtype == dt
    assert out["cache"]["layers"][0]["k"].shape == (
        128, 32_768, st.cfg.n_kv_heads, st.cfg.hd)


def test_mesh_and_parallelism_configs_are_the_references():
    for name in ("SINGLE_POD", "MULTI_POD", "SMOKE_MESH"):
        t, j = getattr(ttypes, name), getattr(jtypes, name)
        assert (t.shape, t.axes, t.n_devices, t.dp_axes, t.tp_axis) == \
            (j.shape, j.axes, j.n_devices, j.dp_axes, j.tp_axis)
        for axis in ("pod", "data", "model", "other"):
            assert t.axis_size(axis) == j.axis_size(axis)
    assert tmesh.mesh_config() is ttypes.SINGLE_POD
    assert tmesh.mesh_config(multi_pod=True) is ttypes.MULTI_POD
    t = {f.name: f.default for f in dataclasses.fields(
        ttypes.ParallelismConfig)}
    j = {f.name: f.default for f in dataclasses.fields(
        jtypes.ParallelismConfig)}
    # every field of the reference's, with its default, in its order
    assert j == t
    assert list(j) == list(t)


@pytest.mark.parametrize("field, value", [("pipeline_stages", 4),
                                          ("param_dtype", "bfloat16")])
def test_unread_parallelism_fields_take_only_their_default(field, value):
    """The reference's ``pipeline_stages`` and ``param_dtype``, which
    nothing reads, are carried for parity and cannot be set."""
    with pytest.raises(NotImplementedError, match=field):
        ttypes.ParallelismConfig(**{field: value})
    jtypes.ParallelismConfig(**{field: value})       # the reference's takes it
    assert getattr(ttypes.ParallelismConfig(), field) == getattr(
        jtypes.ParallelismConfig(), field)


@pytest.mark.parametrize("arch", ["elastic-lstm", "elastic-conv1d"])
def test_paper_designs_smoke_is_their_config(arch):
    """Every config module has ``smoke()``, as the reference's; the
    paper's two designs are smoke-sized already, so it is ``config()``."""
    import importlib

    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_"))
    assert mod.smoke() == mod.config() == get_config(arch, smoke=True) \
        == get_config(arch)
    assert dataclasses.asdict(mod.smoke()) == {
        k: v for k, v in dataclasses.asdict(
            jconfigs.get_config(arch, smoke=True)).items()
        if k in dataclasses.asdict(mod.smoke())}


def test_layout_tuples_are_partition_specs():
    for entries in ((), (None,), ("data", None), (("data",), None, "model"),
                    (("pod", "data"), None), (None, ("model",))):
        assert tlayers.pspec(*entries) == tuple(P(*entries))
    assert tlayers.shard_axis(64, 16) == jlayers.shard_axis(64, 16)
    assert tlayers.shard_axis(14, 16) is None
    assert tlayers.shard_axis(8, 16) is None


def test_production_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 1 ranks"):
        tmesh.make_smoke_mesh(device_type="cpu")


def test_the_package_imports_no_test_internals():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "torch.testing" not in fh.read(), f


# --------------------------------------------------------------------------- #
# Local shapes on fake process groups of 256 and 512 ranks
# --------------------------------------------------------------------------- #

SUB = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ALL_IDS, get_config
    from repro_torch.core import types
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    from repro_torch.model import layers, lm

    def local(tree, sh):
        flat = {}
        def walk(t, s, path):
            if layers.is_pspec(t):
                flat[path] = list(s.shard_shape(t.shape))
            elif isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], s[k], path + "/" + k)
            elif isinstance(t, (tuple, list)):
                for i, x in enumerate(t):
                    walk(x, s[i], path + "/" + str(i))
        walk(tree, sh, "")
        return flat

    out = {}
    for n, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        mcfg = types.MULTI_POD if multi else types.SINGLE_POD
        assert tuple(mesh.mesh_dim_names) == mcfg.axes
        assert tuple(mesh.shape) == mcfg.shape
        got = out[str(n)] = {}
        for arch in ALL_IDS:
            cfg = get_config(arch)
            cells = got[arch] = {}
            for name in types.shapes_for(cfg):
                shape = types.shape_table_for(cfg)[name]
                for scan in (False, True):
                    st = lm.Stepper(cfg, shape, mcfg, types.ParallelismConfig(
                        scan_layers=scan), mesh=mesh)
                    if name == types.shapes_for(cfg)[0] and not scan:
                        cells["params"] = local(st.schema,
                                                st.shardings(st.schema))
                    if shape.kind == "decode":
                        c = st.cache_schema()
                        cells[f"cache/{name}/{scan}"] = local(
                            c, st.shardings(c))
                specs = lm.batch_pspecs(cfg, shape, mcfg)
                cells[f"batch/{name}"] = {
                    k: list(layers.Sharding(mesh, layers.placements(
                        mesh, specs[k])).shard_shape(shp))
                    for k, (shp, _) in lm.input_specs(cfg, shape).items()}
        dist.destroy_process_group()

    # every coordinate's block of an uneven tensor, as torch.chunk cuts it
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_smoke_mesh((2, 4), ("data", "model"), device_type="cpu")
    full = torch.arange(7 * 10).reshape(7, 10)
    ok = []
    try:
        layers.placements(mesh, (None, ("model", "data")))
        ok.append(False)
    except ValueError:
        ok.append(True)                 # only the mesh's order is a Shard's
    for layout in (("data", "model"), (("data", "model"),), ("model",),
                   (None, ("data", "model")), ()):
        s = layers.Sharding(mesh, layers.placements(mesh, layout))
        for d in range(2):
            for m in range(4):
                (h, w), (r0, c0) = s.local_shape_and_offset((7, 10), (d, m))
                want = full
                for dim, entry in enumerate(layout):
                    for axis in ((entry,) if isinstance(entry, str)
                                 else entry or ()):
                        k, i = (2, d) if axis == "data" else (4, m)
                        parts = torch.chunk(want, k, dim)
                        want = parts[i] if i < len(parts) else \\
                            want.narrow(dim, 0, 0)
                got = full[r0:r0 + h, c0:c0 + w]
                ok.append(got.shape == want.shape and
                          (got.numel() == 0 or torch.equal(got, want)))
    dist.destroy_process_group()
    out["chunks_ok"] = all(ok) and len(ok) == 41
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_meshes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", SUB], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _shard_shapes(schema, mesh):
    """{path: NamedSharding(mesh, P).shard_shape(shape)} of a reference
    schema."""
    return {k: list(NamedSharding(mesh, s.pspec).shard_shape(s.shape))
            for k, s in _flat(schema, jlayers.is_pspec).items()
            if s is not None}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_IDS)
def test_local_shapes_on_fake_meshes_equal_the_reference(fake_meshes, arch,
                                                         mesh):
    _, jmc = MESHES[mesh]
    amesh = AbstractMesh(jmc.shape, jmc.axes)
    got = fake_meshes[str(jmc.n_devices)][arch]
    jcfg = jconfigs.get_config(arch)
    table = jtypes.shape_table_for(jcfg)
    names = jtypes.shapes_for(jcfg)
    want = {"params": _shard_shapes(jtf.param_schema(
        jcfg, tp=jmc.axis_size("model")), amesh)}
    for name in names:
        shape = table[name]
        if shape.kind == "decode":
            for scan in (False, True):
                st = jlm.Stepper(jcfg, shape, jmc, jtypes.ParallelismConfig(
                    scan_layers=scan))
                want[f"cache/{name}/{scan}"] = _shard_shapes(
                    st.cache_schema(), amesh)
        specs = jlm.batch_pspecs(jcfg, shape, jmc)
        want[f"batch/{name}"] = {
            k: list(NamedSharding(amesh, specs[k]).shard_shape(s.shape))
            for k, s in jlm.input_specs(jcfg, shape).items()}
    assert sorted(got) == sorted(want)
    for cell in want:
        assert got[cell] == want[cell], cell
    split = sum(g != list(s.shape) for g, s in zip(
        want["params"].values(),
        [s for s in jax.tree.leaves(jtf.param_schema(jcfg, tp=16),
                                    is_leaf=jlayers.is_pspec)]))
    assert split > 0 or arch in ("elastic-lstm", "elastic-conv1d")


def test_every_block_of_an_uneven_tensor_is_torch_chunks(fake_meshes):
    assert fake_meshes["chunks_ok"] is True
