"""PyTorch port, checkpoints, the fault-tolerant ``Trainer`` and
``launch/train.py``: the reference's checkpoint cases
(``tests/test_checkpoint.py``) and trainer cases (``tests/test_runtime.py``)
on the port, checkpoints read across the two packages, the port's restore
of a bfloat16 tree (which the reference cannot restore), and the port's
``Trainer`` against the reference's from the same initial parameters. All
on the CPU.

Tolerances: logged losses within 1e-4 (the reference test's bar for a
replay), gradient norms within 1e-3 relative over 25 AdamW steps of two
float32 programs that sum in other orders; checkpoints bit for bit.
"""
import io
import json
import os
import re
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.checkpoint import ckpt as jckpt
    from repro.configs import get_config as j_get_config
    from repro.core import types as jtypes
    from repro.data.pipeline import LMDataConfig as JLMDataConfig
    from repro.model import lm as jlm
    from repro.runtime import trainer as jtrainer

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.types import SMOKE_MESH, ParallelismConfig, ShapeConfig
from repro_torch.data.pipeline import LMDataConfig
from repro_torch.launch import train as tlaunch
from repro_torch.model.layers import tree_leaves, tree_map
from repro_torch.model.lm import Stepper
from repro_torch.optim.adamw import init_opt_state
from repro_torch.runtime import (FailureInjector, PreemptionError, Trainer,
                                 TrainerConfig)

S, B = 32, 8


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": (torch.ones(3), torch.zeros(2, 2))}}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# The reference's checkpoint cases, on the port
# --------------------------------------------------------------------------- #


def test_roundtrip_exact(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    _equal(load_checkpoint(str(tmp_path), 7, tree_map(torch.zeros_like, t)),
           t)


def test_gc_keeps_last_k(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, _tree(), keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]


def test_tmp_dirs_never_visible_as_latest(tmp_path):
    os.makedirs(tmp_path / "step_00000099.tmp-123")
    save_checkpoint(str(tmp_path), 1, _tree())
    assert latest_step(str(tmp_path)) == 1


def test_async_manager(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(3)
    m.save_async(4, t)
    m.wait()
    step, r = m.restore(tree_map(torch.zeros_like, t))
    assert step == 4
    _equal(r, t)


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 0, {"a": torch.ones(5)})


def test_async_save_is_a_snapshot(tmp_path):
    """The donating step updates the state in place right after
    ``save_async`` returns: the checkpoint holds the values at the call."""
    m = CheckpointManager(str(tmp_path))
    t = _tree(5)
    want = tree_map(torch.clone, t)
    m.save_async(1, t)
    for leaf in tree_leaves(t):
        leaf.add_(1)
    m.wait()
    _equal(m.restore(tree_map(torch.zeros_like, t))[1], want)


def test_bf16_training_state_round_trips_bit_for_bit(tmp_path):
    st = Stepper(get_config("stablelm-3b", smoke=True),
                 ShapeConfig("t", "train", S, B), SMOKE_MESH,
                 ParallelismConfig(compute_dtype="float32"))
    params = st.init(seed=3, device="cpu", dtype_override=torch.bfloat16)
    state = {"params": params, "opt": init_opt_state(params)}
    save_checkpoint(str(tmp_path), 2, state)
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert manifest["keys"]["params/g0/attn/wq"]["dtype"] == "bfloat16"
    assert manifest["keys"]["opt/step"]["dtype"] == "int32"
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as z:
        assert z["params/g0/attn/wq"].dtype == np.dtype("V2")
    _equal(load_checkpoint(str(tmp_path), 2, tree_map(torch.zeros_like,
                                                      state)), state)


# --------------------------------------------------------------------------- #
# Across the two packages
# --------------------------------------------------------------------------- #


def _jtree():
    k = jax.random.PRNGKey(1)
    return {"a": jax.random.normal(k, (8, 4)),
            "nested": {"b": jnp.arange(10, dtype=jnp.int32),
                       "c": (jnp.ones((3,)), jnp.zeros((2, 2))),
                       "skip": None},
            "l": [jnp.full((2,), 3.0)]}


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_read_across_packages(tmp_path):
    jt = _jtree()
    tt = tree_map(lambda a: torch.from_numpy(np.array(a)), jt)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jt)
    save_checkpoint(str(tmp_path / "port"), 3, tt)
    jm, tm = _manifest(tmp_path / "ref", 3), _manifest(tmp_path / "port", 3)
    assert jm["keys"] == tm["keys"] and jm["treedef"] == tm["treedef"]
    with np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz") as zj, \
            np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
    # the port reads the reference's, and the reference the port's
    _equal(load_checkpoint(str(tmp_path / "ref"), 3,
                           tree_map(torch.zeros_like, tt)), tt)
    back = jckpt.load_checkpoint(str(tmp_path / "port"), 3,
                                 jax.tree.map(np.asarray, jt))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_restores_a_reference_bf16_checkpoint(tmp_path):
    """The reference writes a bfloat16 leaf as 2-byte ``V2`` records and
    cannot restore it (``astype`` has no cast from ``V2``); the port
    reinterprets the bits."""
    jt = {"a": jax.random.normal(jax.random.PRNGKey(2), (2, 3),
                                 jnp.bfloat16),
          "b": {"c": jnp.arange(4, dtype=jnp.int32)}}
    jckpt.save_checkpoint(str(tmp_path), 1, jt)
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.load_checkpoint(str(tmp_path), 1, jt)
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    got = load_checkpoint(str(tmp_path), 1, like)
    want = np.asarray(jt["a"]).view(np.int16)
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.arange(4))


# --------------------------------------------------------------------------- #
# The reference's trainer cases, on the port
# --------------------------------------------------------------------------- #


def _par():
    return ParallelismConfig(compute_dtype="float32", attn_impl="flash")


def _mk(td, steps=25, inj=None, seed=7, init=None):
    cfg = get_config("yi-9b", smoke=True)
    st = Stepper(cfg, ShapeConfig("t", "train", S, B), SMOKE_MESH, _par())
    if init is not None:         # the same initial params as the reference
        st.init = lambda seed=0, device=None, dtype_override=None: to_torch(
            init, device=device)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                        seed=seed)
    return Trainer(st, dcfg,
                   TrainerConfig(total_steps=steps, ckpt_every=10,
                                 ckpt_dir=str(td), log_every=5),
                   injector=inj, device="cpu")


def test_recovery_and_exact_replay(tmp_path):
    out = _mk(tmp_path / "a",
              inj=FailureInjector(fail_at_steps={13, 21})).train()
    assert out["recoveries"] == 2
    assert out["steps"] == 25
    clean = _mk(tmp_path / "b").train()
    l1 = {m["step"]: m["loss"] for m in out["metrics"]}
    l2 = {m["step"]: m["loss"] for m in clean["metrics"]}
    for s in l1:
        assert abs(l1[s] - l2[s]) < 1e-4, s
    # the replay is exact: the final states are equal bit for bit
    _equal(out["state"], clean["state"])


def test_loss_decreases(tmp_path):
    out = _mk(tmp_path, steps=40).train()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0], losses


def test_injector_budget():
    inj = FailureInjector(fail_at_steps={5}, max_failures=1)
    with pytest.raises(PreemptionError):
        inj.maybe_fail(5)
    inj.maybe_fail(5)  # second time: budget spent, no raise


def test_trainer_against_reference(tmp_path):
    """25 steps from the same initial parameters and batches: the port's
    Trainer logs the reference's losses and gradient norms."""
    jcfg = j_get_config("yi-9b", smoke=True)
    jst = jlm.Stepper(jcfg, jtypes.ShapeConfig("t", "train", S, B),
                      jtypes.SMOKE_MESH, jtypes.ParallelismConfig(
                          compute_dtype="float32", attn_impl="flash"))
    jout = jtrainer.Trainer(
        jst, JLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                           global_batch=B, seed=7),
        jtrainer.TrainerConfig(total_steps=25, ckpt_every=10,
                               ckpt_dir=str(tmp_path / "ref"),
                               log_every=5)).train()
    init = params_from_jax(jax.tree.map(np.asarray, jst.init()[0]),
                           get_config("yi-9b", smoke=True))
    tout = _mk(tmp_path / "port", init=init).train()
    assert [m["step"] for m in tout["metrics"]] == [
        m["step"] for m in jout["metrics"]]
    for t, j in zip(tout["metrics"], jout["metrics"]):
        assert abs(t["loss"] - j["loss"]) < 1e-4, (t, j)
        assert abs(t["gnorm"] - j["gnorm"]) <= 1e-3 * j["gnorm"], (t, j)
    # and each wrote the same checkpoint steps and keys
    assert latest_step(str(tmp_path / "ref")) == latest_step(
        str(tmp_path / "port")) == 20
    assert _manifest(tmp_path / "ref", 20)["keys"] == _manifest(
        tmp_path / "port", 20)["keys"]


def test_resume_elastic_onto_another_stepper(tmp_path):
    tr = _mk(tmp_path, steps=12)
    out = tr.train()
    cfg = get_config("yi-9b", smoke=True)
    other = Stepper(cfg, ShapeConfig("t2", "train", 2 * S, B // 2),
                    SMOKE_MESH, ParallelismConfig(compute_dtype="float32"))
    step, state = tr.resume_elastic(other)
    assert step == 11
    saved = load_checkpoint(str(tmp_path), 10, tree_map(torch.zeros_like,
                                                         out["state"]))
    _equal(state, saved)
    assert int(state["opt"]["step"]) == 11
    # the restored state trains on the other stepper
    batch = {"tokens": torch.zeros(B // 2, 2 * S, dtype=torch.int32),
             "targets": torch.ones(B // 2, 2 * S, dtype=torch.int32)}
    _, _, m = other.train_fn(donate=True)(state["params"], state["opt"],
                                          batch)
    assert torch.isfinite(m["loss"])


# --------------------------------------------------------------------------- #
# The launcher and the device rule
# --------------------------------------------------------------------------- #


def test_launcher_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tlaunch.main(["--arch", "stablelm-3b", "--steps", "12",
                           "--seq", "32", "--batch", "4", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                           "--scan"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "10", "11"]
    # the straggler count reads the host clock, so it is not pinned
    assert re.fullmatch(r"done: 12 steps, 0 recoveries, \d+ straggler "
                        r"steps \(cpu\)", lines[-1]), lines[-1]
    assert latest_step(str(tmp_path)) == 10


def test_launcher_refuses_a_mesh():
    """``--production`` (with ``--multi-pod``) builds the production mesh,
    which needs a process group of 256 (512) ranks: without one it raises
    ``make_production_mesh``'s RuntimeError, as the reference's launcher
    raises without 256 (512) devices."""
    for flags, n in ((["--production"], 256),
                     (["--production", "--multi-pod"], 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            tlaunch.main(["--arch", "yi-9b", *flags, "--device", "cpu"])


def test_no_device_means_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b", smoke=True)
    st = Stepper(cfg, ShapeConfig("t", "train", S, B), SMOKE_MESH, _par())
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(st, dcfg, TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "yi-9b", "--ckpt-dir", str(tmp_path)])
