"""PyTorch port, ZeRO-1 and the elastic reshard: ``opt_state_schema``
given a mesh, ``load_checkpoint(shardings=)``/``CheckpointManager.
restore``/``Trainer.resume_elastic`` and the mesh train step, against the
reference.

* ZeRO layouts: every config's moment layouts on ``SINGLE_POD`` and
  ``MULTI_POD`` equal ``tuple(P)`` of the reference's, and (on fake
  process groups of 256 and 512 ranks, in a subprocess, metadata only)
  every moment's local shape equals the reference's
  ``NamedSharding.shard_shape``.
* The elastic restart of ``tests/test_multidevice.py``: ``yi-9b`` smoke
  trained 12 steps on a (4, 2) mesh from the reference's initial
  parameters (the port as 8 ``gloo`` ranks, the reference with 8 forced
  host devices: ``tests/torch_ranks.py``), losses within 1e-4 of the
  reference's; resumed on (2, 4) at step 11 with each rank's leaves equal
  to its slices of the saved arrays; the next loss within 1e-4 of the
  reference's; the checkpoint (rank 0's, whole arrays) restores in the
  reference's loader.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import numpy as np
import pytest

import torch_ranks as tr
from repro_torch.configs import ALL_IDS, get_config
from repro_torch.core import types as ttypes
from repro_torch.model import layers as tlayers
from repro_torch.model.transformer import param_schema
from repro_torch.optim import adamw as tadamw

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.checkpoint import ckpt as jckpt
    from repro.core import types as jtypes
    from repro.model import lm as jlm
    from repro.model.transformer import param_schema as j_param_schema
    from repro.optim import adamw as jadamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": (ttypes.SINGLE_POD, jtypes.SINGLE_POD),
          "multi": (ttypes.MULTI_POD, jtypes.MULTI_POD)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic"))
    ref = tr.run_ref("elastic", d, timeout=300)
    return ref, tr.run_port("elastic", 8, d, timeout=300)


# --------------------------------------------------------------------------- #
# ZeRO-1 layouts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_IDS)
def test_zero_layouts_are_the_references(arch, mesh):
    tmc, jmc = MESHES[mesh]
    tp = tmc.axis_size("model")
    t = tadamw.opt_state_schema(param_schema(get_config(arch), tp=tp), tmc)
    j = jadamw.opt_state_schema(
        j_param_schema(jconfigs.get_config(arch), tp=tp), jmc)
    for part in ("mu", "nu"):
        got = [(tuple(s.shape), s.pspec) for s in tlayers.tree_leaves(
            t[part], tlayers.is_pspec)]
        want = [(tuple(s.shape), tuple(s.pspec)) for s in jax.tree.leaves(
            j[part], is_leaf=lambda x: hasattr(x, "pspec"))]
        assert got == want
    assert t["step"].pspec == tuple(j["step"].pspec) == ()
    # zero_dims names the dim each moment splits over the data axes
    dims = tadamw.zero_dims(param_schema(get_config(arch), tp=tp), tmc)
    for z, s in zip(dims, tlayers.tree_leaves(t["mu"], tlayers.is_pspec)):
        if z is None:
            assert not any(set(tmc.dp_axes) & set(
                (e,) if isinstance(e, str) else e or ()) for e in s.pspec)
        else:
            assert s.shape[z] % np.prod([tmc.axis_size(a)
                                         for a in tmc.dp_axes]) == 0


def test_no_mesh_config_means_no_zero():
    sch = param_schema(get_config("yi-9b"), tp=16)
    t = tadamw.opt_state_schema(sch)
    # the parameter's layout, padded with None to every dim (as tuple(P))
    assert [s.pspec for s in tlayers.tree_leaves(t["mu"], tlayers.is_pspec)] \
        == [tuple(s.pspec) + (None,) * (len(s.shape) - len(s.pspec))
            for s in tlayers.tree_leaves(sch, tlayers.is_pspec)]


SUB = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ALL_IDS, get_config
    from repro_torch.core import types
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.model import layers, lm

    out = {}
    for n, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        mcfg = types.MULTI_POD if multi else types.SINGLE_POD
        for arch in ALL_IDS:
            st = lm.Stepper(get_config(arch), types.SHAPES["train_4k"], mcfg,
                            types.ParallelismConfig(), mesh=mesh)
            sh = st.state_shardings()["opt"]["mu"]
            specs = layers.tree_leaves(lm.opt_state_schema(
                st.schema, mcfg)["mu"], layers.is_pspec)
            out[f"{n}/{arch}"] = [
                list(s.shard_shape(p.shape)) for s, p in zip(
                    layers.tree_leaves(sh, lambda x: isinstance(
                        x, layers.Sharding)), specs)]
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_zero_local_shapes_on_fake_process_groups():
    """Every moment's block on the 256- and 512-rank meshes (the fake
    backend, metadata only) is the reference's ``shard_shape``."""
    from jax.sharding import AbstractMesh, NamedSharding

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", SUB], capture_output=True,
                       text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for n, (name, jmc) in ((256, ("single", jtypes.SINGLE_POD)),
                           (512, ("multi", jtypes.MULTI_POD))):
        amesh = AbstractMesh(jmc.shape, jmc.axes)
        for arch in ALL_IDS:
            j = jadamw.opt_state_schema(j_param_schema(
                jconfigs.get_config(arch), tp=jmc.axis_size("model")), jmc)
            want = [list(NamedSharding(amesh, s.pspec).shard_shape(s.shape))
                    for s in jax.tree.leaves(
                        j["mu"], is_leaf=lambda x: hasattr(x, "pspec"))]
            assert got[f"{n}/{arch}"] == want, arch


# --------------------------------------------------------------------------- #
# The elastic restart
# --------------------------------------------------------------------------- #


def test_losses_against_reference(runs):
    ref, port = runs
    got, want = port[0]["losses"], ref["losses"]
    assert got.shape == want.shape == (tr.E_STEPS,)
    assert float(np.max(np.abs(got - want))) < 1e-4


def test_only_rank_0_writes_and_logs(runs):
    _, port = runs
    assert [r["writer"] for r in port] == [True] + [False] * 7
    assert all(len(r["losses"]) == 0 for r in port[1:])


def test_resume_lands_each_rank_on_its_slices(runs):
    ref, port = runs
    for r in port:
        assert r["resume_step"] == ref["resume_step"] == 11
        assert r["n_leaves"] > 0 and r["mismatched"] == []


def test_next_loss_against_reference(runs):
    ref, port = runs
    for r in port:
        assert abs(r["next_loss"] - ref["next_loss"]) < 1e-4
        assert r["next_loss"] == port[0]["next_loss"]


def test_checkpoint_restores_in_reference_loader(runs):
    """Rank 0 wrote whole arrays in the files' one format: the
    reference's loader restores the port's mesh checkpoint."""
    _, port = runs
    d = port[0]["ckpt_dir"]
    step = jckpt.latest_step(d)
    assert step == 10
    cfg = jconfigs.get_config("yi-9b", smoke=True)
    st = jlm.Stepper(cfg, jtypes.ShapeConfig("t", "train", tr.E_S, tr.E_B),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    params, opt = st.init()
    back = jckpt.load_checkpoint(d, step, {"params": params, "opt": opt})
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    flat = jckpt._flatten(back)
    assert sorted(flat) == sorted(saved)
    for k, v in flat.items():
        assert np.array_equal(v, saved[k]), k
