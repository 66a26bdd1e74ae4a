"""Readings of the reference (the JAX package) beside the port's, on the
CPU, for findings that rest on what the reference itself does
(ROADMAP §C8, §C9). Not a test module; ``tests/test_torch_rwkv.py`` runs
``bf16_drift`` at the smoke size.

    # C8: how far bf16 compute drifts from f32 over the same bf16 weights,
    # RWKV6-7B at full width and 2 layers, a 512-token prompt (~12 GB)
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/reference_witness.py \\
        bf16-drift rwkv6-7b 2 512

    # C9: the RWKV smoke LM's f32 gradient against the reference's f64
    # one, at (constant-leaf noise scale:batch seed) points
    JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python tests/reference_witness.py grad-noise 0:11 0:13 0.3:11
"""
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import configs as jconfigs
    from repro.core import types as jtypes
    from repro.model import lm as jlm

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_torch  # noqa: E402
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig  # noqa: E402
from repro_torch.model import lm as tlm  # noqa: E402
from repro_torch.model.layers import tree_leaves, value_and_grad  # noqa: E402


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def bf16_drift(arch: str, n_layers: int, seq: int, smoke: bool,
               seed: int = 0) -> dict:
    """The last-position logits of one ``seq``-token prefill in bfloat16
    and in float32 compute over the same bfloat16-rounded weights (the
    reference's ``Stepper.init`` draw), in both packages: each package's
    bf16 run against its own f32 run (relative rms), the port's runs
    against the reference's, and the argmax of each."""
    jcfg = jconfigs.get_config(arch, smoke=smoke).with_(n_layers=n_layers)
    tcfg = get_config(arch, smoke=smoke).with_(n_layers=n_layers)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", seq, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jparams, _ = st.init(seed=seed)
    w32 = jax.tree.map(lambda a: np.asarray(jnp.asarray(
        a, jnp.bfloat16).astype(jnp.float32)), jparams)
    del jparams, st
    tokens = np.random.default_rng(seed + 1).integers(
        2, tcfg.vocab_size, (1, seq)).astype(np.int32)
    out = {}
    for dt in ("float32", "bfloat16"):
        fn = jlm.make_prefill_step(jcfg, jtypes.SMOKE_MESH,
                                   jtypes.ParallelismConfig(compute_dtype=dt))
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), w32)
        out[("ref", dt)] = np.asarray(fn(p, {"tokens": jnp.asarray(
            tokens)})[0], np.float32)
        del p, fn
    tw = params_from_jax(w32, tcfg)
    del w32
    for dt in ("float32", "bfloat16"):
        fn = tlm.make_prefill_step(tcfg, SMOKE_MESH,
                                   ParallelismConfig(compute_dtype=dt))
        p = to_torch(tw, device="cpu", dtype=getattr(torch, dt))
        with torch.no_grad():
            out[("port", dt)] = fn(p, {"tokens": torch.from_numpy(
                tokens).long()})[0].float().numpy()
        del p, fn
    return {
        "ref bf16 vs ref f32": rel_rms(out["ref", "bfloat16"],
                                       out["ref", "float32"]),
        "port bf16 vs port f32": rel_rms(out["port", "bfloat16"],
                                         out["port", "float32"]),
        "port bf16 vs ref bf16": rel_rms(out["port", "bfloat16"],
                                         out["ref", "bfloat16"]),
        "port f32 vs ref f32": rel_rms(out["port", "float32"],
                                       out["ref", "float32"]),
        "argmax": {f"{pkg} {dt}": int(v.argmax())
                   for (pkg, dt), v in out.items()},
    }


def grad_noise(scale: float, seed: int, arch: str = "rwkv6-7b") -> str:
    """The ``arch`` smoke LM's loss gradient at the reference's
    ``Stepper.init`` draw (seed 3), its constant leaves plus ``scale``
    times seeded normal noise, on a (2, 16) batch from ``seed``: the
    worst leaf's relative rms of the port's f32 gradient against the
    reference's f32 one, of the reference's f32 against its f64, and of
    the port's f32 against the reference's f64. Needs JAX's 64-bit
    types."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    st = jlm.Stepper(jcfg, jtypes.ShapeConfig("p", "prefill", 32, 1),
                     jtypes.SMOKE_MESH,
                     jtypes.ParallelismConfig(compute_dtype="float32"))
    jparams, _ = st.init(seed=3)
    rng = np.random.default_rng(26)

    def vary(a):
        a = np.asarray(a, np.float32)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a

    npar = jax.tree.map(vary, jparams)
    tcfg = get_config(arch, smoke=True)
    tparams = to_torch(params_from_jax(npar, tcfg), device="cpu")
    brng = np.random.default_rng(seed)
    batch = {k: brng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    grads = {}
    for dt in ("float32", "float64"):
        fn = jlm.make_loss_fn(jcfg, jtypes.SMOKE_MESH,
                              jtypes.ParallelismConfig(compute_dtype=dt),
                              None)
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), npar)
        _, g = jax.value_and_grad(fn, has_aux=True)(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
        grads[dt] = [np.asarray(x) for x in jax.tree.leaves(g)]
    _, tg = value_and_grad(tlm.make_loss_fn(tcfg, SMOKE_MESH, ParallelismConfig(
        compute_dtype="float32")), has_aux=True)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    port = [t.numpy() for t in tree_leaves(tg)]

    def worst(a, b):
        return max(rel_rms(x, y) for x, y in zip(a, b))

    return (f"scale {scale} batch seed {seed}: port vs reference "
            f"{worst(port, grads['float32']):.2e}, reference f32 vs f64 "
            f"{worst(grads['float32'], grads['float64']):.2e}, port vs f64 "
            f"{worst(port, grads['float64']):.2e}")


def main(argv) -> int:
    if argv[:1] == ["bf16-drift"]:
        arch, n_layers, seq = argv[1], int(argv[2]), int(argv[3])
        read = bf16_drift(arch, n_layers, seq, smoke=False)
        print(f"{arch}, full width, {n_layers} layers, one {seq}-token "
              "prefill, last-position logits, relative rms: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in read.items() if k != "argmax")
              + f"; argmax {read['argmax']}", flush=True)
        return 0
    if argv[:1] == ["grad-noise"]:
        if not jax.config.jax_enable_x64:
            sys.exit("reference_witness grad-noise: set JAX_ENABLE_X64=1")
        for arg in argv[1:] or ["0:11", "0:13", "0.3:11"]:
            scale, seed = arg.split(":")
            print(grad_noise(float(scale), int(seed)), flush=True)
        return 0
    sys.exit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
