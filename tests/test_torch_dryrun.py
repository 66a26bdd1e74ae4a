"""PyTorch port, the multi-pod dry-run (``repro_torch/launch/dryrun.py``):
each cell's step of rank 0 counted on ``meta`` tensors in a process whose
fake ``torch.distributed`` group has the mesh's ranks, against the
reference's ``repro/launch/dryrun.py`` (whose compiles are not run here:
its cell list, its shard shapes and its report's keys are read from its
own modules).

* ``--all`` (and ``--both-meshes``) lists the reference's cells:
  ``ALL_IDS`` × ``shapes_for``, on 16 × 16 and 2 × 16 × 16.
* Every arch's train cell on both meshes, at the depth of its plan's
  first count: the argument bytes of the parameter and ZeRO-1 moment
  blocks equal the bytes of the reference's shard shapes of its params
  and moments (``NamedSharding.shard_shape`` on an ``AbstractMesh``).
* The reference's ``tests/test_multidevice.py::
  test_dryrun_minimal_mesh_compiles``: internvl2-1b at 2 layers, train
  512 × 8 on a (2, 4) mesh, FLOPs > 0 and wire bytes > 0; the logged
  wire bytes by kind equal ``shardmap``'s own tally of its regions'
  collectives (``shardmap.wire_bytes``) plus the ``DTensor``
  redistributions'.
* ``extrapolate`` equals ``unroll`` within 1e-9 (relative) in FLOPs,
  bytes and wire bytes, on the yi-9b smoke at 8 layers (train and
  decode) and the zamba2-7b smoke at 13 (the three-point plan, with the
  full config's unit of 6 layers).
* The yi-9b smoke's train step on (2, 2): its matmul FLOPs a device × 4
  equal the meshless step's (every matmul splits, the batch halves).
* rwkv6-7b's train cell (2 layers) on 16 × 16: fewer FLOPs a device split
  than computed whole (``split=False``).
* A collective counts no FLOPs, its bytes on the ``ici`` channel.
* ``main`` writes the reference's JSON keys; importing the module starts
  no process group and sets no environment variable.

Each case runs in a subprocess: a process holds one process group.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro_torch.launch import dryrun as tdr

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import types as jtypes
    from repro.energy.roofline import RooflineReport as JRooflineReport
    from repro.model import layers as jlayers
    from repro.model import transformer as jtf
    from repro.optim import adamw as jadamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": False, "2x16x16": True}
# a case's subprocess takes under 60 s on an idle host
TIMEOUT = 600


def _run(code: str) -> dict:
    """The JSON the last line of ``code``'s output holds, ``code`` run in
    a fresh interpreter with the port on its path."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def test_cell_list_is_the_references():
    want = [(arch, sh) for arch in jconfigs.ALL_IDS
            for sh in jtypes.shapes_for(jconfigs.get_config(arch))]
    assert tdr.all_cells() == want
    args = tdr.parse_args(["--all", "--both-meshes"])
    assert tdr.cells_for(args) == [(mp, a, s) for mp in (False, True)
                                   for a, s in want]
    assert tdr.cells_for(tdr.parse_args(["--all", "--multi-pod"])) == [
        (True, a, s) for a, s in want]
    assert tdr.cells_for(tdr.parse_args(
        ["--arch", "rwkv6-7b", "--shape", "train_4k"])) == [
            (False, "rwkv6-7b", "train_4k")]
    assert tdr.MESH_NAMES == {False: "16x16", True: "2x16x16"}


# --------------------------------------------------------------------------- #
# Every arch's train cell: its argument bytes are the reference's shards'
# --------------------------------------------------------------------------- #

TRAIN = """
    import json
    from repro_torch.configs import ALL_IDS, get_config
    from repro_torch.core.types import ParallelismConfig, shape_table_for
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh, mesh_config

    multi = {multi}
    mcfg = mesh_config(multi_pod=multi)
    dr.fake_world(mcfg.n_devices)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    out = {{}}
    for arch in ALL_IDS:
        cfg = get_config(arch)
        cfg = cfg.with_(n_layers=dr.extrapolation_plan(cfg)[0][0])
        table = shape_table_for(cfg)
        shape = table["train_batch" if "train_batch" in table
                      else "train_4k"]
        cost, mem, coll, _ = dr._compile_cell(cfg, shape, mcfg, mesh,
                                              ParallelismConfig())
        out[arch] = dict(mem.arguments, n_layers=cfg.n_layers,
                         shape=shape.name, flops=cost["flops"],
                         argument=mem.argument_size_in_bytes)
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def train_cells():
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as ex:
        return dict(zip(MESHES, ex.map(
            lambda m: _run(TRAIN.format(multi=MESHES[m])), MESHES)))


def _shard_bytes(schema, mesh) -> int:
    return sum(
        int(np.prod(NamedSharding(mesh, s.pspec).shard_shape(s.shape)))
        * jnp.dtype(s.dtype).itemsize
        for s in jax.tree.leaves(schema, is_leaf=jlayers.is_pspec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_train_cell_argument_bytes_are_the_reference_shards(
        train_cells, arch, mesh):
    got = train_cells[mesh][arch]
    jmc = jtypes.MULTI_POD if MESHES[mesh] else jtypes.SINGLE_POD
    jcfg = jconfigs.get_config(arch).with_(n_layers=got["n_layers"])
    schema = jtf.param_schema(jcfg, tp=jmc.axis_size("model"))
    amesh = AbstractMesh(jmc.shape, jmc.axes)
    assert got["params"] == _shard_bytes(schema, amesh)
    assert got["opt_state"] == _shard_bytes(
        jadamw.opt_state_schema(schema, jmc), amesh)
    assert got["argument"] == got["params"] + got["opt_state"] + \
        got["batch"]
    assert got["flops"] > 0


# --------------------------------------------------------------------------- #
# The reference's minimal-mesh case, and the collectives' two counts
# --------------------------------------------------------------------------- #


def test_dryrun_minimal_mesh_compiles():
    """A miniature production mesh (2x4) exercises the full dry-run path
    (shardings, donation, roofline) quickly."""
    r = _run("""
        import json
        from repro_torch import shardmap as sm
        from repro_torch.configs import get_config
        from repro_torch.core.types import (MeshConfig, ParallelismConfig,
                                            ShapeConfig)
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_smoke_mesh

        class Log(dr._Collectives):
            # the log, with the DTensor redistributions' wire bytes apart
            dtensor = {}

            def __torch_dispatch__(self, func, types, args=(), kw=None):
                before = dict(self.stats.wire_bytes)
                out = super().__torch_dispatch__(func, types, args, kw)
                if func.namespace == "_c10d_functional":
                    for k, v in self.stats.wire_bytes.items():
                        self.dtensor[k] = (self.dtensor.get(k, 0.0) + v
                                           - before.get(k, 0.0))
                return out

        dr._Collectives = Log
        dr.fake_world(8)
        cfg = get_config("internvl2-1b").with_(n_layers=2)
        shape = ShapeConfig("t", "train", 512, 8)
        mcfg = MeshConfig((2, 4), ("data", "model"))
        mesh = make_smoke_mesh((2, 4), device_type="cpu")
        par = ParallelismConfig()
        sm.reset_wire_bytes()
        cost, mem, coll, dt = dr._compile_cell(cfg, shape, mcfg, mesh, par)
        print(json.dumps({
            "flops": cost["flops"], "ici": cost["work"]["ici"],
            "wire": coll.total_wire_bytes, "counts": coll.counts,
            "by_kind": coll.wire_bytes,
            "tallied": {k: sm.wire_bytes.get(k, 0.0) + Log.dtensor.get(k, 0.0)
                        for k in set(sm.wire_bytes) | set(Log.dtensor)},
            "ops_wire": sum(o[3] for o in coll.ops),
            "alias": mem.alias_size_in_bytes,
            "donated": mem.arguments["params"] + mem.arguments["opt_state"],
            "groups": sorted({o[1] for o in coll.ops})}))
    """)
    assert r["flops"] > 0
    assert r["wire"] > 0
    assert _rel(r["ops_wire"], r["wire"]) < 1e-12
    assert set(r["by_kind"]) == set(r["tallied"])
    for k, v in r["tallied"].items():
        assert _rel(r["by_kind"][k], v) < 1e-12
    assert r["ici"] > 0
    assert set(r["groups"]) <= {2, 4}
    # the donating update writes the parameters and moments in place
    assert r["alias"] == r["donated"]


def test_a_collective_counts_no_flops():
    r = _run("""
        import json
        import torch
        import torch.distributed as dist
        from repro_torch.energy.cost import count_step
        from repro_torch.launch import dryrun as dr

        dr.fake_world(4)
        x = torch.empty(8, 16, device="meta")
        c = count_step(lambda t: dist.all_reduce(t), (x,))
        print(json.dumps({"flops": c.flops, "ici": c.work["ici"],
                          "bytes": c.bytes_accessed}))
    """)
    assert r == {"flops": 0.0, "ici": 2 * 8 * 16 * 4.0,
                 "bytes": 2 * 8 * 16 * 4.0}


# --------------------------------------------------------------------------- #
# extrapolate against unroll; the split's FLOPs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,layers,shape", [("yi-9b", 8, "train_4k"),
                                               ("zamba2-7b", 13, "train_4k"),
                                               ("yi-9b", 8, "decode_32k")])
def test_extrapolate_equals_unroll(arch, layers, shape):
    """Eager counts are affine in depth: the plan's two (zamba2: three)
    reduced-depth counts give the full-depth FLOPs, bytes and wire bytes
    (and collective counts) at the smoke width. zamba2's smoke takes its
    full config's unit of 6 layers: the plan's third point, a unit and two
    layers (``u + 2``), is that only where a unit has more than 2."""
    r = _run(f"""
        import json
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun as dr

        def small(cfg):
            c = get_config({arch!r}, smoke=True).with_(n_layers={layers})
            if c.shared_attn_every:       # the full config's unit
                c = c.with_(shared_attn_every=6)
            return c

        out = {{}}
        for mode in ("unroll", "extrapolate"):
            rep, _ = dr.lower_cell({arch!r}, {shape!r}, multi_pod=False,
                                   mode=mode, cfg_transform=small,
                                   verbose=False)
            out[mode] = [rep.flops_per_device, rep.bytes_per_device,
                         rep.wire_bytes_per_device, rep.collectives.counts,
                         len(dr.extrapolation_plan(small(None)))]
        print(json.dumps(out))
    """)
    un, ex = r["unroll"], r["extrapolate"]
    assert ex[4] == (3 if arch == "zamba2-7b" else 2)
    for a, b in zip(ex[:3], un[:3]):
        assert _rel(a, b) < 1e-9
    assert ex[3] == un[3]
    assert un[0] > 0


def test_yi_split_step_computes_a_quarter_of_the_matmuls_on_2x2():
    r = _run("""
        import json
        import torch
        from repro_torch.configs import get_config
        from repro_torch.core.types import (SMOKE_MESH, MeshConfig,
                                            ParallelismConfig, ShapeConfig)
        from repro_torch.energy.cost import count_step
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.model import lm

        dr.fake_world(4)
        cfg = get_config("yi-9b", smoke=True)
        shape = ShapeConfig("t", "train", 64, 4)
        par = ParallelismConfig()
        mcfg = MeshConfig((2, 2), ("data", "model"))
        mesh = make_smoke_mesh((2, 2), device_type="cpu")
        cost, _, _, _ = dr._compile_cell(cfg, shape, mcfg, mesh, par)
        st = lm.Stepper(cfg, shape, SMOKE_MESH, par)
        ab = st.abstract_inputs()
        whole = count_step(st.train_fn(), (ab["params"], ab["opt_state"],
                                           ab["batch"]))
        print(json.dumps({"split": cost["work"]["mxu"],
                          "whole": whole.work["mxu"]}))
    """)
    assert r["whole"] > 0
    assert _rel(4 * r["split"], r["whole"]) < 1e-9


def test_rwkv6_split_counts_fewer_flops_than_the_whole_form():
    r = _run("""
        import json
        from repro_torch.configs import get_config
        from repro_torch.core.types import ParallelismConfig, SHAPES
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_production_mesh, mesh_config

        mcfg = mesh_config()
        dr.fake_world(mcfg.n_devices)
        mesh = make_production_mesh(device_type="cpu")
        cfg = get_config("rwkv6-7b").with_(n_layers=2)
        out = {}
        for split in (True, False):
            cost, _, coll, _ = dr._compile_cell(
                cfg, SHAPES["train_4k"], mcfg, mesh, ParallelismConfig(),
                split=split)
            out[str(split)] = [cost["flops"], cost["work"]["mxu"]]
        print(json.dumps(out))
    """)
    split, whole = r["True"], r["False"]
    assert 0 < split[0] < whole[0]
    assert split[1] < whole[1] / 8


# --------------------------------------------------------------------------- #
# The CLI and the import
# --------------------------------------------------------------------------- #


def test_main_writes_the_references_json(tmp_path):
    r = _run(f"""
        import json, pathlib
        from repro_torch.launch import dryrun as dr

        rc = dr.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                      "--mode", "unroll", "--json", {str(tmp_path)!r}])
        p = pathlib.Path({str(tmp_path)!r}) / \\
            "whisper-tiny__decode_32k__16x16.json"
        print(json.dumps({{"rc": rc, "report": json.loads(p.read_text())}}))
    """)
    assert r["rc"] == 0
    rep = r["report"]
    want = ({f.name for f in dataclasses.fields(JRooflineReport)}
            - {"collectives"}) | {
                "collective_counts", "collective_local_bytes",
                "collective_wire_bytes", "collectives_in_while",
                "compile_seconds"}
    assert set(rep) == want
    assert (rep["arch"], rep["shape"], rep["mesh"], rep["n_devices"]) == (
        "whisper-tiny", "decode_32k", "16x16", 256)
    assert rep["flops_per_device"] > 0
    assert rep["compute_s"] == rep["flops_per_device"] / 989e12


def test_importing_the_module_starts_no_process_group():
    r = _run("""
        import json, os
        import torch.distributed as dist
        env = dict(os.environ)
        import repro_torch.launch.dryrun
        print(json.dumps({"group": dist.is_initialized(),
                          "env": dict(os.environ) == env}))
    """)
    assert r == {"group": False, "env": True}
