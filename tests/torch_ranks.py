"""The multi-rank jobs of the collectives' parity tests (not a test
module): ``tests/test_torch_shardmap.py``, ``test_torch_compress.py``,
``test_torch_moe_ep.py``, ``test_torch_elastic.py`` and
``test_torch_tp.py``.

The port runs as N ``gloo`` ranks under ``torch.multiprocessing`` (each
with one thread, the process group initialised from a file in the job's
directory); the reference runs in one process with 8 forced host devices
(``--xla_force_host_platform_device_count=8``, ``JAX_PLATFORMS=cpu``), as
``tests/test_multidevice.py`` runs it: the test process keeps seeing one
device, and ``repro.shardmap`` imports outside pytest's warning filter.
Each job writes a pickle of numpy arrays; the reference's runs first, and
the port's reads its inputs (the reference's parameters among them).

    python tests/torch_ranks.py ref JOB OUTDIR [ARGS]
    python tests/torch_ranks.py port JOB WORLD OUTDIR
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# ---------------------------------------------------------------------------
# Launchers (called by the tests)
# ---------------------------------------------------------------------------


def _run(args, env, timeout: int) -> None:
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise AssertionError(f"{args[:2]} timed out after {timeout} s\n"
                             f"STDOUT:\n{out[-4000:]}\nSTDERR:\n"
                             f"{err[-4000:]}")
    assert p.returncode == 0, (f"{args[:2]} exited {p.returncode}\nSTDOUT:\n"
                               f"{out[-4000:]}\nSTDERR:\n{err[-8000:]}")


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def run_ref(job: str, outdir: str, timeout: int = 300,
            args: tuple = ()) -> dict:
    """The reference's ``job`` (its function's further string ``args``
    also name its pickle)."""
    _run(["ref", job, outdir, *args], _env(
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"), timeout)
    name = "_".join(("ref", job) + tuple(args))
    with open(os.path.join(outdir, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def run_port(job: str, world: int, outdir: str, timeout: int = 300) -> list:
    """Every rank's result, by rank."""
    _run(["port", job, str(world), outdir], _env(OMP_NUM_THREADS="1"),
         timeout)
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"port_{job}_{world}_{r}.pkl"),
                  "rb") as f:
            out.append(pickle.load(f))
    return out


def _dump(obj, path: str) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _np(t) -> np.ndarray:
    import torch

    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _rng(key: int):
    return np.random.default_rng(key)


# ---------------------------------------------------------------------------
# shardmap: the helper's collectives and their gradients
# ---------------------------------------------------------------------------

MESHES = ((2, 2), (2, 4))


class _JaxOps:
    def __init__(self):
        import jax
        import jax.numpy as jnp

        self.lax, self.np = jax.lax, jnp

    def psum(self, x, a):
        return self.lax.psum(x, a)

    def pmean(self, x, a):
        return self.lax.pmean(x, a)

    def idx(self, a):
        return self.lax.axis_index(a)

    def gather(self, x, a, dim, tiled):
        return self.lax.all_gather(x, a, axis=dim, tiled=tiled)

    def a2a(self, x, a):
        return self.lax.all_to_all(x, a, 0, 0, tiled=False)

    def perm(self, x, a, p):
        return self.lax.ppermute(x, a, p)

    def sin(self, x):
        return self.np.sin(x)

    def rowsum(self, x):
        return self.np.sum(x, axis=-1, keepdims=True)


class _TorchOps:
    def __init__(self):
        import torch

        from repro_torch import shardmap as sm

        self.sm, self.torch = sm, torch

    def psum(self, x, a):
        return self.sm.psum(x, a)

    def pmean(self, x, a):
        return self.sm.pmean(x, a)

    def idx(self, a):
        return self.sm.axis_index(a)

    def gather(self, x, a, dim, tiled):
        return self.sm.all_gather(x, a, axis=dim, tiled=tiled)

    def a2a(self, x, a):
        return self.sm.all_to_all(x, a, 0, 0, tiled=False)

    def perm(self, x, a, p):
        return self.sm.ppermute(x, a, p)

    def sin(self, x):
        return self.torch.sin(x)

    def rowsum(self, x):
        return x.sum(-1, keepdim=True)


def _cases(P, shape):
    """name -> (in_specs, out_specs, body(ops, tp) -> fn, input shapes,
    axis_names, check_vma). ``shape`` is the (data, model) mesh."""
    dp, tp = shape
    n = dp * tp
    return {
        # the [3, 3] case: a P() operand, its cotangent summed over model
        "psum_index": ((P(),), P(),
                       lambda o: lambda x: o.psum(x * (1 + o.idx("model")),
                                                  "model"),
                       [None], None, None),
        "matmul": ((P("data", None), P(None, "model")),
                   (P("data", "model"), P("data", None)),
                   lambda o: lambda x, w: (
                       x @ w, o.psum(o.rowsum(o.sin(x @ w)), "model")),
                   [(4 * dp, 6), (6, 2 * tp)], None, None),
        "gather_tiled": ((P("model", None),), P(),
                         lambda o: lambda x: o.gather(
                             x * (1 + o.idx("model")), "model", 0, True),
                         [(2 * tp, 3)], None, False),
        "gather_stacked": ((P(None, "model"),), P(),
                           lambda o: lambda x: o.gather(
                               o.sin(x), "model", 1, False),
                           [(3, 2 * tp)], None, False),
        "all_to_all": ((P("model", None, None),), P("model", None, None),
                       lambda o: lambda x: o.a2a(
                           x * (1 + o.idx("model")), "model"),
                       [(tp * tp, 3, 2)], None, None),
        "ppermute": ((P("model", None),), P("model", None),
                     lambda o: lambda x: o.perm(
                         x * x, "model", [(i, (i + 1) % tp)
                                          for i in range(tp)]),
                     [(2 * tp, 3)], None, None),
        "pmean_pair": ((P(("data", "model"), None),),
                       (P(), P(("data", "model"), None)),
                       lambda o: lambda x: (
                           o.pmean(o.sin(x), ("data", "model")),
                           x * 0 + o.idx(("data", "model"))),
                       [(2 * n, 3)], None, None),
        # manual over "data" only: "model" stays as the caller holds it
        "data_only": ((P("data", None), P()), P(),
                      lambda o: lambda x, w: o.psum(x @ w, "data"),
                      [(2 * dp, 3), (3, 4)], {"data"}, None),
    }


def _inputs(name, shapes, key):
    if name == "psum_index":
        return [np.array([1.0, 2.0], np.float32)]
    rng = _rng(key)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cots(outs, key):
    if key == 0:                       # psum_index: the plain sum
        return [np.ones(np.shape(o), np.float32) for o in outs]
    rng = _rng(1000 + key)
    return [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


def ref_shardmap(outdir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.shardmap import shard_map

    ops, res = _JaxOps(), {}
    for shape in MESHES:
        mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        for k, (name, (ins, outs, body, shapes, axes, vma)) in enumerate(
                _cases(P, shape).items()):
            f = shard_map(body(ops), mesh=mesh, in_specs=ins, out_specs=outs,
                          axis_names=axes, check_vma=vma)
            xs = [jnp.asarray(a) for a in _inputs(name, shapes, k)]
            with mesh:
                y = jax.jit(f)(*xs)
                ys = list(y) if isinstance(y, tuple) else [y]
                cs = [jnp.asarray(c) for c in _cots(ys, k)]

                def loss(*a):
                    o = f(*a)
                    o = list(o) if isinstance(o, tuple) else [o]
                    return sum(jnp.sum(oi * ci) for oi, ci in zip(o, cs))

                g = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(
                    *xs)
            res[f"{shape}/{name}"] = {"inputs": [np.asarray(a) for a in xs],
                                      "outs": [np.asarray(a) for a in ys],
                                      "grads": [np.asarray(a) for a in g]}
    _dump(res, os.path.join(outdir, "ref_shardmap.pkl"))


def port_shardmap(rank, world, outdir):
    import torch

    from repro_torch import shardmap as sm
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.shardmap import P

    ref = _load(os.path.join(outdir, "ref_shardmap.pkl"))
    ops, res = _TorchOps(), {}
    for shape in MESHES:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_smoke_mesh(shape, device_type="cpu")
        for k, (name, (ins, outs, body, shapes, axes, _)) in enumerate(
                _cases(P, shape).items()):
            f = sm.shard_map(body(ops), mesh=mesh, in_specs=ins,
                             out_specs=outs, axis_names=axes)
            xs = [torch.tensor(a, requires_grad=True)
                  for a in ref[f"{shape}/{name}"]["inputs"]]
            sm.reset_wire_bytes()
            y = f(*xs)
            ys = list(y) if isinstance(y, tuple) else [y]
            cs = [torch.tensor(c) for c in _cots(
                [o.detach().numpy() for o in ys], k)]
            sum((o * c).sum() for o, c in zip(ys, cs)).backward()
            res[f"{shape}/{name}"] = {
                "outs": [_np(o) for o in ys], "grads": [_np(x.grad)
                                                         for x in xs],
                "wire": dict(sm.wire_bytes)}
        if shape == (2, 2):
            res["dtensor"] = _dtensor_case(mesh, ref)
            res["dist_nn"] = _dist_nn_case(mesh)
    _dump(res, os.path.join(outdir, f"port_shardmap_{world}_{rank}.pkl"))


def _dtensor_case(mesh, ref):
    """``matmul`` with ``w`` a DTensor (its model-split placement): the
    plain tensors' outputs, and its gradient placed as ``w``'s."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import shardmap as sm
    from repro_torch.shardmap import P

    ins, outs, body, _, _, _ = _cases(P, (2, 2))["matmul"]
    x, w = (torch.tensor(a) for a in ref["(2, 2)/matmul"]["inputs"])
    wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
    wd.requires_grad_(True)
    f = sm.shard_map(body(_TorchOps()), mesh=mesh, in_specs=ins,
                     out_specs=outs)
    y = f(x, wd)
    cs = [torch.tensor(c) for c in _cots(
        [o.detach().numpy() for o in y], 1)]
    sum((o * c).sum() for o, c in zip(y, cs)).backward()
    return {"outs": [_np(o) for o in y],
            "w_grad": _np(wd.grad.full_tensor())}


def _dist_nn_case(mesh):
    """``torch.distributed.nn``'s all-reduce over ``"model"`` of 2: the
    gradient of ``sum(all_reduce(y))`` it gives (2, where the region's
    rules give 1)."""
    import torch
    from torch.distributed.nn.functional import all_reduce

    y = torch.ones(2, requires_grad=True)
    all_reduce(y * 1.0, group=mesh.get_group("model")).sum().backward()
    return _np(y.grad)


# ---------------------------------------------------------------------------
# compress: the int8 all-reduces on 8 ranks, and the compressed trainer
# ---------------------------------------------------------------------------

VEC = 1000
WIRE = 1 << 16
TRAIN_STEPS = 15


def _compress_inputs():
    rng = _rng(7)
    x = rng.standard_normal((8, VEC)).astype(np.float32)
    tree = {"a": rng.standard_normal((8, 12, 5)).astype(np.float32),
            "b": rng.standard_normal((8, 33)).astype(np.float32)}
    ef = (0.01 * rng.standard_normal((8, 12 * 5 + 33))).astype(np.float32)
    return x, tree, ef


def ref_compress(outdir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.energy.roofline import parse_collectives
    from repro.optim import compress as C
    from repro.shardmap import shard_map

    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))
    x, tree, ef = _compress_inputs()

    def body(x, a, b, e):
        x, a, b, e = x[0], a[0], b[0], e[0]
        q, sc = C._quant(x)
        (ta, tb), new_ef = C.compressed_psum_tree((a, b), "data", e)
        return tuple(v[None] for v in (
            jax.lax.psum(x, "data"), C.compressed_psum_vec(x, "data"),
            C.compressed_psum_butterfly(x, "data"),
            C.compressed_psum_local_quant(x, "data"), q, sc, ta, tb,
            new_ef))

    f = shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                  axis_names={"data"}, check_vma=False)
    with mesh:
        outs = jax.jit(f)(jnp.asarray(x), jnp.asarray(tree["a"]),
                          jnp.asarray(tree["b"]), jnp.asarray(ef))
    names = ("exact", "ring", "butterfly", "local_quant", "q", "scale",
             "tree_a", "tree_b", "new_ef")
    res = {k: np.asarray(v) for k, v in zip(names, outs)}

    f32 = shard_map(lambda v: jax.lax.psum(v, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P(),
                    axis_names={"data"}, check_vma=False)
    cmp = shard_map(lambda v: C.compressed_psum_vec(v, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P(),
                    axis_names={"data"}, check_vma=False)
    sds = jax.ShapeDtypeStruct((8 * WIRE,), jnp.float32)
    with mesh:
        res["wire_f32"] = parse_collectives(
            jax.jit(f32).lower(sds).compile().as_text(), 8).total_wire_bytes
        res["wire_int8"] = parse_collectives(
            jax.jit(cmp).lower(sds).compile().as_text(), 8).total_wire_bytes
    res.update(_ref_compressed_trainer())
    _dump(res, os.path.join(outdir, "ref_compress.pkl"))


def _ref_compressed_trainer():
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.types import MeshConfig, ParallelismConfig, ShapeConfig
    from repro.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro.model.lm import Stepper

    cfg = get_config("yi-9b", smoke=True)
    mcfg = MeshConfig((4, 2), ("data", "model"))
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    par = ParallelismConfig(compute_dtype="float32", grad_compression=True)
    st = Stepper(cfg, ShapeConfig("t", "train", 32, 8), mcfg, par, mesh=mesh)
    params, opt = st.init()
    init = jax.tree.map(np.asarray, params)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8)
    losses = []
    with mesh:
        step = jax.jit(st.train_fn())
        batch = lm_batch_for_step(dcfg, 0)
        for _ in range(TRAIN_STEPS):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
    return {"train_init": init, "train_losses": np.asarray(losses)}


def port_compress(rank, world, outdir):
    import torch

    from repro_torch import shardmap as sm
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import compress as C
    from repro_torch.shardmap import P

    mesh = make_smoke_mesh((8,), ("data",), device_type="cpu")
    x, tree, ef = (_compress_inputs())
    res = {}

    def body(x, a, b, e):
        x, a, b, e = x[0], a[0], b[0], e[0]
        q, sc = C._quant(x)
        (ta, tb), new_ef = C.compressed_psum_tree((a, b), "data", e)
        return tuple(v[None] for v in (
            sm.psum(x, "data"), C.compressed_psum_vec(x, "data"),
            C.compressed_psum_butterfly(x, "data"),
            C.compressed_psum_local_quant(x, "data"), q, sc, ta, tb,
            new_ef))

    f = sm.shard_map(body, mesh=mesh, in_specs=P("data"),
                     out_specs=P("data"), axis_names={"data"})
    outs = f(*(torch.tensor(v) for v in (x, tree["a"], tree["b"], ef)))
    names = ("exact", "ring", "butterfly", "local_quant", "q", "scale",
             "tree_a", "tree_b", "new_ef")
    res.update({k: _np(v) for k, v in zip(names, outs)})

    v = torch.tensor(_rng(8).standard_normal(8 * WIRE).astype(np.float32))
    for key, fn in (("wire_f32", lambda t: sm.psum(t, "data")),
                    ("wire_int8", lambda t: C.compressed_psum_vec(t,
                                                                  "data"))):
        g = sm.shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=P(),
                         axis_names={"data"})
        sm.reset_wire_bytes()
        g(v)
        res[key] = sum(sm.wire_bytes.values())
    res.update(_port_compressed_trainer(outdir))
    res["production"] = _production_refuses()
    _dump(res, os.path.join(outdir, f"port_compress_{world}_{rank}.pkl"))


def _port_compressed_trainer(outdir):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_torch
    from repro_torch.core.types import (MeshConfig, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.model.layers import local_blocks
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import init_opt_state

    ref = _load(os.path.join(outdir, "ref_compress.pkl"))
    cfg = get_config("yi-9b", smoke=True)
    mcfg = MeshConfig((4, 2), ("data", "model"))
    mesh = make_smoke_mesh((4, 2), device_type="cpu")
    par = ParallelismConfig(compute_dtype="float32", grad_compression=True)
    st = Stepper(cfg, ShapeConfig("t", "train", 32, 8), mcfg, par, mesh=mesh)
    params = to_torch(params_from_jax(ref["train_init"], cfg), "cpu")
    sh = st.state_shardings()
    state = local_blocks({"params": params, "opt": init_opt_state(params)},
                         sh)
    params, opt = state["params"], state["opt"]
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8)
    batch = {k: torch.as_tensor(v)
             for k, v in lm_batch_for_step(dcfg, 0).items()}
    step = st.train_fn()
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return {"train_losses": np.asarray(losses)}


def _production_refuses():
    """``launch/train.py --production``'s error in this world of 8."""
    from repro_torch.launch import train as tlaunch

    for flags in (["--production"], ["--production", "--multi-pod"]):
        try:
            tlaunch.main(["--arch", "yi-9b", *flags, "--device", "cpu"])
        except RuntimeError as e:
            msg = str(e)
        else:
            return "did not raise"
    return msg


# ---------------------------------------------------------------------------
# moe_ep: moe_psum / moe_a2a on a (2, 4) mesh
# ---------------------------------------------------------------------------

CAPS = (8.0, 1.25)
MOE_IMPLS = ("dense", "psum", "a2a")


def _moe_x(d):
    return _rng(11).standard_normal((4, 8, d)).astype(np.float32)


def _moe_cots(d):
    rng = _rng(12)
    return (rng.standard_normal((4, 8, d)).astype(np.float32),
            np.float32(3.0))


def ref_moe_ep(outdir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.types import MeshConfig, ParallelismConfig
    from repro.model import moe
    from repro.model.layers import Ctx, init_params

    cfg0 = get_config("qwen3-moe-30b-a3b", smoke=True)
    mcfg = MeshConfig((2, 4), ("data", "model"))
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    par = ParallelismConfig(compute_dtype="float32")
    params = init_params(moe.moe_schema(cfg0, tp=4), jax.random.PRNGKey(0))
    x = jnp.asarray(_moe_x(cfg0.d_model))
    cy, ca = (jnp.asarray(c) for c in _moe_cots(cfg0.d_model))
    res = {"params": jax.tree.map(np.asarray, params), "x": np.asarray(x)}
    for cap in CAPS:
        cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, capacity_factor=cap))
        for impl in MOE_IMPLS:
            fn = moe.IMPLS[impl]

            def loss(p, xx):
                ctx = Ctx(cfg=cfg, mesh_cfg=mcfg, mode="train", mesh=mesh,
                          par=par)
                y, aux = fn(p, xx, cfg, ctx)
                return jnp.sum(y * cy) + aux * ca, (y, aux)

            with mesh:
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(params, x)
            res[f"{cap}/{impl}"] = {
                "y": np.asarray(y), "aux": float(aux), "gx": np.asarray(gx),
                "gp": jax.tree.map(np.asarray, gp)}
    _dump(res, os.path.join(outdir, "ref_moe_ep.pkl"))


def port_moe_ep(rank, world, outdir):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import MeshConfig, ParallelismConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.model import moe
    from repro_torch.model.layers import Ctx, tree_map

    ref = _load(os.path.join(outdir, "ref_moe_ep.pkl"))
    cfg0 = get_config("qwen3-moe-30b-a3b", smoke=True)
    mcfg = MeshConfig((2, 4), ("data", "model"))
    mesh = make_smoke_mesh((2, 4), device_type="cpu")
    par = ParallelismConfig(compute_dtype="float32")
    cy, ca = (torch.tensor(c) for c in _moe_cots(cfg0.d_model))
    res = {}
    for cap in CAPS:
        cfg = cfg0.with_(moe=dataclasses.replace(cfg0.moe,
                                                 capacity_factor=cap))
        for impl in MOE_IMPLS:
            # with the aux loss, and (at the no-drop capacity) without it:
            # the impls' aux losses are different estimators
            for key, w_aux in ((f"{cap}/{impl}", ca),
                               (f"{cap}/{impl}/y", 0.0)):
                if key.endswith("/y") and cap != CAPS[0]:
                    continue
                p = tree_map(lambda a: torch.tensor(a, requires_grad=True),
                             ref["params"])
                x = torch.tensor(ref["x"], requires_grad=True)
                ctx = Ctx(cfg=cfg, mesh_cfg=mcfg, mode="train", mesh=mesh,
                          par=par)
                y, aux = moe.IMPLS[impl](p, x, cfg, ctx)
                (torch.sum(y * cy) + aux * w_aux).backward()
                res[key] = {
                    "y": _np(y), "aux": float(aux.detach()),
                    "gx": _np(x.grad),
                    "gp": tree_map(lambda t: _np(t.grad), p)}
    res.update(_moe_train_steps(mesh, mcfg))
    _dump(res, os.path.join(outdir, f"port_moe_ep_{world}_{rank}.pkl"))


def _moe_train_steps(mesh, mcfg):
    """One mesh train step (ZeRO-1, the experts local, the attention,
    embedding and head computed split) against the meshless step from the same parameters and
    batch, for each EP impl at a no-drop capacity with no aux loss (the
    two then compute one function): loss, global norm and the updated
    parameters, gathered whole on rank 0."""
    import torch

    from repro_torch.checkpoint.ckpt import gather_tree
    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model.layers import local_blocks, tree_leaves
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import init_opt_state

    out = {}
    cfg0 = get_config("qwen3-moe-30b-a3b", smoke=True)
    shape = ShapeConfig("t", "train", 8, 4)
    batch = {k: torch.as_tensor(v) for k, v in lm_batch_for_step(
        LMDataConfig(vocab_size=cfg0.vocab_size, seq_len=8,
                     global_batch=4), 0).items()}
    for impl in ("psum", "a2a"):
        cfg = cfg0.with_(moe=dataclasses.replace(
            cfg0.moe, impl=impl, capacity_factor=8.0, aux_loss_coef=0.0))
        par = ParallelismConfig(compute_dtype="float32")
        st0 = Stepper(cfg, shape, SMOKE_MESH, par)
        st1 = Stepper(cfg, shape, mcfg, par, mesh=mesh)
        params = st0.init(seed=1, device="cpu")
        p0, _, m0 = st0.train_fn()(params, init_opt_state(params), batch)
        sh = st1.state_shardings()
        state = local_blocks({"params": params,
                              "opt": init_opt_state(params)}, sh)
        p1, _, m1 = st1.train_fn()(state["params"], state["opt"], batch)
        whole = gather_tree(p1, sh["params"], mesh)     # rank 0's alone
        out[f"train/{impl}"] = {
            "loss": (float(m0["loss"]), float(m1["loss"])),
            "gnorm": (float(m0["gnorm"]), float(m1["gnorm"])),
            "params": None if whole is None else [
                (_np(a), _np(b)) for a, b in zip(tree_leaves(p0),
                                                 tree_leaves(whole))]}
    return out


# ---------------------------------------------------------------------------
# elastic: train on (4, 2), resume on (2, 4)
# ---------------------------------------------------------------------------

E_S, E_B, E_STEPS = 16, 8, 12


def ref_elastic(outdir):
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.types import MeshConfig, ParallelismConfig, ShapeConfig
    from repro.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro.model.lm import Stepper
    from repro.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("yi-9b", smoke=True)
    par = ParallelismConfig(compute_dtype="float32")
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=E_S,
                        global_batch=E_B)
    td = os.path.join(outdir, "ref_ckpt")
    mcfg1 = MeshConfig((4, 2), ("data", "model"))
    mesh1 = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    st1 = Stepper(cfg, ShapeConfig("t", "train", E_S, E_B), mcfg1, par,
                  mesh=mesh1)
    init = jax.tree.map(np.asarray, st1.init()[0])
    tr1 = Trainer(st1, dcfg, TrainerConfig(total_steps=E_STEPS,
                                           ckpt_every=5, ckpt_dir=td,
                                           log_every=1))
    with mesh1:
        out1 = tr1.train()
    mcfg2 = MeshConfig((2, 4), ("data", "model"))
    mesh2 = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    st2 = Stepper(cfg, ShapeConfig("t", "train", E_S, E_B), mcfg2, par,
                  mesh=mesh2)
    step, state = tr1.resume_elastic(st2)
    with mesh2:
        _, _, m = jax.jit(st2.train_fn())(state["params"], state["opt"],
                                          lm_batch_for_step(dcfg, step))
    _dump({"init": init,
           "losses": np.asarray([r["loss"] for r in out1["metrics"]]),
           "resume_step": step, "next_loss": float(m["loss"])},
          os.path.join(outdir, "ref_elastic.pkl"))


def port_elastic(rank, world, outdir):
    import torch

    from repro_torch.checkpoint.ckpt import _items
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_torch
    from repro_torch.core.types import (MeshConfig, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.model.lm import Stepper
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    ref = _load(os.path.join(outdir, "ref_elastic.pkl"))
    cfg = get_config("yi-9b", smoke=True)
    par = ParallelismConfig(compute_dtype="float32")
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=E_S,
                        global_batch=E_B)
    td = os.path.join(outdir, "port_ckpt")
    init = params_from_jax(ref["init"], cfg)
    shape = ShapeConfig("t", "train", E_S, E_B)
    st1 = Stepper(cfg, shape, MeshConfig((4, 2), ("data", "model")), par,
                  mesh=make_smoke_mesh((4, 2), device_type="cpu"))
    st1.init = lambda *a, **k: to_torch(init, "cpu")
    tr1 = Trainer(st1, dcfg, TrainerConfig(total_steps=E_STEPS, ckpt_every=5,
                                           ckpt_dir=td, log_every=1),
                  device="cpu")
    out1 = tr1.train()
    st2 = Stepper(cfg, shape, MeshConfig((2, 4), ("data", "model")), par,
                  mesh=make_smoke_mesh((2, 4), device_type="cpu"))
    st2.init = lambda *a, **k: to_torch(init, "cpu")
    step, state = tr1.resume_elastic(st2)
    # each rank's leaves against its slices of the saved arrays
    sh = st2.state_shardings()
    with np.load(os.path.join(td, f"step_{step - 1:08d}", "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    from repro_torch.checkpoint.ckpt import _sharding_items

    shard_of = dict(_sharding_items(state, sh))
    mismatched = []
    for key, leaf in _items(state):
        shp, off = shard_of[key].local_shape_and_offset(saved[key].shape)
        want = saved[key][tuple(slice(o, o + n) for o, n in zip(off, shp))]
        if not np.array_equal(_np(leaf), want):
            mismatched.append(key)
    batch = {k: torch.as_tensor(v)
             for k, v in lm_batch_for_step(dcfg, step).items()}
    _, _, m = st2.train_fn()(state["params"], state["opt"], batch)
    _dump({"losses": np.asarray([r["loss"] for r in out1["metrics"]]),
           "resume_step": step, "next_loss": float(m["loss"]),
           "mismatched": mismatched, "n_leaves": len(shard_of),
           "ckpt_dir": td, "writer": tr1.is_writer},
          os.path.join(outdir, f"port_elastic_{world}_{rank}.pkl"))


# ---------------------------------------------------------------------------
# tp: the "model" split of the transformer families' steps
# ---------------------------------------------------------------------------

#: the reference's jobs of one mesh, run side by side
TP_GROUPS = {"dense": ("yi", "yi/scan", "yi/uneven", "internvl6"),
             "hybrid": ("zamba2",),
             "ssm": ("rwkv6",),
             "moe": ("deepseek/dense", "deepseek/psum", "deepseek/a2a")}
TP_VARIANTS = tuple(v for g in TP_GROUPS.values() for v in g)
TP_SERVED = ("yi", "internvl6", "zamba2", "rwkv6", "deepseek/dense")
TP_S, TP_B, TP_STEPS, TP_NEW = 8, 4, 3, 4
TP_PROMPTS = ([5, 9, 13, 17, 21, 25], [7, 11, 3, 19, 23, 29])
#: "yi/uneven" masks this many targets of the first row, in the first
#: data shard's part of the batch on both meshes, and none of the other's
TP_MASKED = 3


def _tp_cfg(get_config, name):
    """The yi-9b smoke (GQA: 4 q heads, 2 kv heads; also scanned over its
    layers, ``_tp_par``, and on a batch masked unevenly over "data",
    ``_tp_batch_fn``), the internvl2-1b smoke with 6 q heads (whole at a
    model axis of 4), the zamba2-7b smoke (8 Mamba-2 heads, ``d_inner``
    128, a shared block of 4 heads), the rwkv6-7b smoke (4 heads of 16,
    ``d_ff`` 128) and the deepseek-moe-16b smoke (shared experts, a dense
    first layer) with each MoE impl."""
    arch, _, impl = name.partition("/")
    if arch == "yi":
        return get_config("yi-9b", smoke=True)
    if arch == "internvl6":
        return dataclasses.replace(get_config("internvl2-1b", smoke=True),
                                   n_heads=6)
    if arch == "zamba2":
        return get_config("zamba2-7b", smoke=True)
    if arch == "rwkv6":
        return get_config("rwkv6-7b", smoke=True)
    cfg = get_config("deepseek-moe-16b", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


def _tp_par(ParallelismConfig, name):
    return ParallelismConfig(compute_dtype="float32",
                             scan_layers=name.endswith("/scan"))


def _tp_batch_fn(cfg, lm_batch_for_step, name):
    """Either package's trainer ``batch_fn``: the LM batch of a step, its
    first ``TP_MASKED`` targets masked for "yi/uneven" and, for the
    vision config, the same patches at every step."""
    def batch_fn(data_cfg, step):
        b = lm_batch_for_step(data_cfg, step)
        if name.endswith("/uneven"):
            b["targets"] = b["targets"].copy()
            b["targets"][0, :TP_MASKED] = -1
        if cfg.frontend == "vision":
            b["patches"] = _rng(21).standard_normal(
                (TP_B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)
        return b

    return batch_fn


def _serve(Server, ServerConfig, cfg, params, mesh_cfg, par, **kw):
    """Either package's ``Server``: the greedy tokens of ``TP_PROMPTS``,
    and the server."""
    srv = Server(cfg, params, ServerConfig(
        batch_slots=2, max_len=len(TP_PROMPTS[0]) + TP_NEW, eos_token=-1),
        mesh_cfg, par, **kw)
    for prompt in TP_PROMPTS:
        srv.submit(prompt, max_new_tokens=TP_NEW)
    done = srv.run_until_drained()
    return [list(r.out_tokens) for r in done], srv


#: the yi-9b smoke's further serving scenarios: (batch_slots, each
#: request's max_new_tokens, how many of the last requests are submitted
#: after the first tick). "refill": slot 1 retires after its second
#: token and takes the third request while slot 0 decodes, a round in
#: which data rank 0 admits nothing; "late": one request in the first
#: round, so data rank 1 builds its pool from zeros, and a second one
#: into it a tick later; "whole": 3 slots, which the data axes do not
#: divide, so every rank holds the whole pool
TP_SCENARIOS = {"refill": (2, (4, 2, 4), 0), "late": (2, (3, 3), 1),
                "whole": (3, (4, 2, 4), 0)}
TP_SCENARIO_PROMPTS = TP_PROMPTS + ([31, 4, 27, 8, 15, 2],)
#: the MoE impls whose prefill cuts its batch over "data" (step 4)
TP_REFUSED = ("deepseek/psum", "deepseek/a2a")


def _serve_scenario(Server, ServerConfig, cfg, params, mesh_cfg, par, name,
                    **kw):
    """Either package's ``Server`` on ``TP_SCENARIOS[name]``: the greedy
    tokens and the server."""
    slots, news, late = TP_SCENARIOS[name]
    srv = Server(cfg, params, ServerConfig(
        batch_slots=slots, max_len=len(TP_PROMPTS[0]) + max(news),
        eos_token=-1), mesh_cfg, par, **kw)
    reqs = list(zip(TP_SCENARIO_PROMPTS, news))
    for prompt, n in reqs[:len(reqs) - late]:
        srv.submit(prompt, max_new_tokens=n)
    if late:
        srv.step()
        for prompt, n in reqs[len(reqs) - late:]:
            srv.submit(prompt, max_new_tokens=n)
    done = srv.run_until_drained()
    return [list(r.out_tokens) for r in done], srv


def _refusal(Server, ServerConfig, cfg, params, mesh_cfg, par, **kw):
    """What ``Server(mesh=)`` raises serving ``TP_PROMPTS`` (None if it
    serves): the error's type and first line."""
    try:
        _serve(Server, ServerConfig, cfg, params, mesh_cfg, par, **kw)
    except Exception as e:                          # noqa: BLE001
        return type(e).__name__, str(e).splitlines()[0]
    return None


def _tp_mesh(name: str):
    return tuple(int(n) for n in name.split("x"))


def ref_tp(outdir, mesh_name, group):
    """On the ``mesh_name`` ("2x2", "2x4") mesh, for each variant of
    ``TP_GROUPS[group]``: the losses of ``TP_STEPS`` steps of the
    reference's train step (its XLA-partitioned loss gradient, the
    parameters laid out by their layouts and the batch over "data", then
    ``adamw_update``, as its ``make_train_step`` composes them), the first
    step's gradients, and its ``Server(mesh=)``'s greedy tokens (yi-9b's
    also on ``TP_SCENARIOS``; for ``TP_REFUSED`` what it raises)."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.types import MeshConfig, ParallelismConfig, ShapeConfig
    from repro.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro.model.lm import Stepper, make_loss_fn
    from repro.optim.adamw import adamw_update, init_opt_state
    from repro.runtime.server import Server, ServerConfig

    shape = ShapeConfig("t", "train", TP_S, TP_B)
    shp = _tp_mesh(mesh_name)
    mcfg = MeshConfig(shp, ("data", "model"))
    mesh = Mesh(np.asarray(jax.devices()[:shp[0] * shp[1]]).reshape(shp),
                ("data", "model"))
    whole = NamedSharding(mesh, P())
    res, inits = {}, {}
    for name in TP_GROUPS[group]:
        cfg = _tp_cfg(get_config, name)
        par = _tp_par(ParallelismConfig, name)
        batch_fn = _tp_batch_fn(cfg, lm_batch_for_step, name)
        dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TP_S,
                            global_batch=TP_B)
        st = Stepper(cfg, shape, mcfg, par, mesh=mesh)
        arch = name.partition("/")[0]    # one init for the arch's variants
        if arch not in inits:
            inits[arch] = jax.jit(lambda: st.init()[0])()
        params = inits[arch]
        psh = st.shardings(st.schema)
        bsh = {k: NamedSharding(mesh, P("data", *[None] * (v.ndim - 1)))
               for k, v in batch_fn(dcfg, 0).items()}
        grad = jax.jit(jax.value_and_grad(
            make_loss_fn(cfg, mcfg, par, mesh), has_aux=True),
            in_shardings=(psh, bsh))
        update = jax.jit(lambda g, o, p: adamw_update(g, o, p, st.opt_cfg))
        out = {"init": jax.tree.map(np.asarray, params),
               "batch": batch_fn(dcfg, 0)}
        with mesh:
            p = jax.device_put(params, psh)
            opt, losses = init_opt_state(params), []
            for step in range(TP_STEPS):
                (loss, m), g = grad(p, batch_fn(dcfg, step))
                if step == 0:
                    out.update(loss=float(loss), n_tok=int(m["n_tok"]),
                               grads=jax.tree.map(np.asarray, g))
                p, opt, _ = update(g, jax.device_put(opt, whole), p)
                p = jax.device_put(p, psh)
                losses.append(float(m["loss"]))
            out["tokens"] = (_serve(Server, ServerConfig, cfg, params, mcfg,
                                    par, mesh=mesh)[0]
                             if name in TP_SERVED else None)
            if name == "yi":
                out["scenarios"] = {
                    sc: _serve_scenario(Server, ServerConfig, cfg, params,
                                        mcfg, par, sc, mesh=mesh)[0]
                    for sc in TP_SCENARIOS}
            if name in TP_REFUSED:
                out["refusal"] = _refusal(Server, ServerConfig, cfg, params,
                                          mcfg, par, mesh=mesh)
        res[name] = dict(out, train_losses=np.asarray(losses))
    _dump(res, os.path.join(outdir, f"ref_tp_{mesh_name}_{group}.pkl"))


def _tp_full(tree, shardings):
    """Every leaf whole on every rank, from the rank's blocks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.model.layers import tree_map

    return tree_map(lambda t, s: DTensor.from_local(
        t, s.mesh, s.placements, run_check=False).full_tensor(),
        tree, shardings)


def _digest(tree) -> str:
    import hashlib

    from repro_torch.model.layers import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(_np(t).tobytes())
    return h.hexdigest()


def port_tp(rank, world, outdir):
    """The port on the (2, 2) (world 4) or (2, 4) (world 8) mesh, from the
    reference's parameters and batches: each variant's loss and
    gradients (gathered whole on every rank) from the split step and the
    whole-step form, the mesh ``Trainer``'s losses, and for the served
    variants ``Server(mesh=)``'s greedy tokens, its cache's kv heads and
    rows, whether ``lm.pool_zeros`` gives its cache's shapes and dtypes,
    and the meshless ``Server``'s tokens; yi-9b's on ``TP_SCENARIOS``
    with the requests each rank prefilled and its exchanges; for
    ``TP_REFUSED`` what ``Server(mesh=)`` raises and the wire bytes moved
    before it; then the counters."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_torch
    from repro_torch.core.types import (SMOKE_MESH, MeshConfig,
                                        ParallelismConfig, ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.model import lm
    from repro_torch import shardmap as sm
    from repro_torch.model.layers import local_blocks, tree_leaves, tree_map
    from repro_torch.obs import capture
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    mesh_name = {4: "2x2", 8: "2x4"}[world]
    ref = {}
    for group in TP_GROUPS:
        ref.update(_load(os.path.join(outdir,
                                      f"ref_tp_{mesh_name}_{group}.pkl")))
    shp = _tp_mesh(mesh_name)
    mcfg = MeshConfig(shp, ("data", "model"))
    mesh = make_smoke_mesh(shp, device_type="cpu")
    shape = ShapeConfig("t", "train", TP_S, TP_B)
    res = {}
    for name in TP_VARIANTS:
        cfg = _tp_cfg(get_config, name)
        par = _tp_par(ParallelismConfig, name)
        params = to_torch(params_from_jax(ref[name]["init"], cfg), "cpu")
        batch = {k: torch.as_tensor(v)
                 for k, v in ref[name]["batch"].items()}
        st = lm.Stepper(cfg, shape, mcfg, par, mesh=mesh)
        sh = st.state_shardings()["params"]
        blocks = local_blocks(params, sh)
        out = {"blocks": tree_map(lambda t: tuple(t.shape),
                                  lm.model_blocks(params, cfg, mcfg, mesh))}
        for form, split in (("split", True), ("whole", False)):
            with CommDebugMode() as comm:
                loss, m, g = lm._mesh_grad_fn(cfg, mcfg, par, mesh, split)(
                    blocks, batch)
            full = _tp_full(g, sh)
            out[form] = {"loss": float(loss), "n_tok": float(m["n_tok"]),
                         "digest": _digest(full),
                         "gathers": sum(v for k, v in
                                        comm.get_comm_counts().items()
                                        if "all_gather" in str(k)),
                         "grads": (tree_map(_np, full) if rank == 0
                                   else None)}
        st.init = lambda *a, **k: params
        tr = Trainer(st, LMDataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TP_S, global_batch=TP_B),
                     TrainerConfig(total_steps=TP_STEPS, ckpt_every=100,
                                   log_every=1,
                                   ckpt_dir=tempfile.mkdtemp(dir=outdir)),
                     batch_fn=_tp_batch_fn(cfg, lm_batch_for_step, name),
                     device="cpu")
        out["train_losses"] = [m["loss"] for m in tr.train()["metrics"]]
        if name in TP_SERVED:
            out["tokens"], srv = _serve(Server, ServerConfig, cfg, params,
                                        mcfg, par, device="cpu", mesh=mesh)
            out["cache_heads"] = _cache_heads(srv._cache)
            out["meshless_tokens"] = _serve(Server, ServerConfig, cfg,
                                            params, SMOKE_MESH, par,
                                            device="cpu")[0]
            out["pool_zeros"] = _leaf_kinds(lm.pool_zeros(
                cfg, mcfg, par, 2, len(TP_PROMPTS[0]) + TP_NEW, mesh,
                torch.device("cpu"))) == _leaf_kinds(srv._cache)
        if name == "yi":
            out["scenarios"] = {}
            for sc in TP_SCENARIOS:
                with capture() as cap:
                    toks, srv = _serve_scenario(Server, ServerConfig, cfg,
                                                params, mcfg, par, sc,
                                                device="cpu", mesh=mesh)
                spans = cap.trace.spans
                out["scenarios"][sc] = {
                    "tokens": toks, "rows": _cache_heads(srv._cache)["rows"],
                    "prefilled": [s.attrs["rid"] for s in spans
                                  if s.name == "server.prefill"],
                    "exchanges": sum(s.name == "server.exchange"
                                     for s in spans),
                    "finite": all(bool(torch.isfinite(t).all()) for t in
                                  tree_leaves(srv._cache)),
                    "meshless": _serve_scenario(
                        Server, ServerConfig, cfg, params, SMOKE_MESH, par,
                        sc, device="cpu")[0]}
        if name in TP_REFUSED:
            sm.reset_wire_bytes()
            out["refusal"] = _refusal(Server, ServerConfig, cfg, params,
                                      mcfg, par, device="cpu", mesh=mesh)
            out["refusal_wire"] = dict(sm.wire_bytes)
        res[name] = out
    res["counter"] = _tp_counter(mcfg, mesh, ref["yi"]["init"],
                                 ref["yi"]["batch"])
    _dump(res, os.path.join(outdir, f"port_tp_{world}_{rank}.pkl"))


def _cache_heads(cache) -> dict:
    """The heads a server's cache holds: the kv heads of its first
    attention (zamba2's shared block's), for a Mamba-2 layer its SSM
    state's heads and its conv state's ``d_inner`` channels, for an
    RWKV-6 layer its ``wkv`` state's heads and its shift states' width;
    and ``rows``, the batch rows of its leaves (each size once)."""
    from repro_torch.model.layers import tree_leaves

    rows = sorted({int(t.shape[0]) for t in tree_leaves(cache)})
    first = cache["layers"][0]
    if "wkv" in first:
        return {"wkv": int(first["wkv"].shape[1]),
                "shift_att": int(first["shift_att"].shape[1]),
                "shift_ffn": int(first["shift_ffn"].shape[1]), "rows": rows}
    if "ssm" not in first:
        return {"kv": int(first["k"].shape[2]), "rows": rows}
    return {"kv": int(cache["shared"][0]["k"].shape[2]),
            "ssm": int(first["ssm"].shape[1]),
            "conv_x": int(first["conv_x"].shape[2]), "rows": rows}


def _leaf_kinds(cache) -> list:
    """Every leaf's shape and dtype, in tree order."""
    from repro_torch.model.layers import tree_leaves

    return [(tuple(t.shape), str(t.dtype)) for t in tree_leaves(cache)]


def _tp_counter(mcfg, mesh, init, batch_np):
    """The yi-9b smoke (no recompute: ``remat="none"``, one CE pass:
    ``ce_chunked=False``) through the split and the whole step's gradient:
    the helper's wire bytes by kind, the ``DTensor`` collectives by op
    (``CommDebugMode``: the leaves the region gathers), and every
    gradient block's size."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import shardmap as sm
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_torch
    from repro_torch.core.types import ParallelismConfig, ShapeConfig
    from repro_torch.model import lm
    from repro_torch.model.layers import local_blocks, tree_leaves

    cfg = get_config("yi-9b", smoke=True).with_(remat="none",
                                                ce_chunked=False)
    par = ParallelismConfig(compute_dtype="float32")
    st = lm.Stepper(cfg, ShapeConfig("t", "train", TP_S, TP_B), mcfg, par,
                    mesh=mesh)
    sh = st.state_shardings()["params"]
    blocks = local_blocks(to_torch(params_from_jax(init, cfg), "cpu"), sh)
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = {}
    for form, split in (("split", True), ("whole", False)):
        fn = lm._mesh_grad_fn(cfg, mcfg, par, mesh, split)
        sm.reset_wire_bytes()
        with CommDebugMode() as comm:
            _, _, g = fn(blocks, batch)
        out[form] = {"wire": dict(sm.wire_bytes),
                     "comm": {str(k): v for k, v in
                              comm.get_comm_counts().items()},
                     "grad_numel": sum(t.numel() for t in tree_leaves(g))}
    return out


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def _rank_main(rank, world, job, outdir, store):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        globals()[f"port_{job}"](rank, world, outdir)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    side, job = argv[0], argv[1]
    if side == "ref":
        sys.path.insert(0, SRC)
        globals()[f"ref_{job}"](argv[2], *argv[3:])
        return 0
    import torch.multiprocessing as mp

    world, outdir = int(argv[2]), argv[3]
    # a fresh store file each run: a stale one would join an old group
    store = os.path.join(tempfile.mkdtemp(dir=outdir), "pg")
    mp.spawn(_rank_main, args=(world, job, outdir, store), nprocs=world)
    return 0


def tempdir() -> str:
    return tempfile.mkdtemp(prefix="torch_ranks_")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
