"""PyTorch port, the int8 gradient all-reduce (``repro_torch/optim/
compress.py``) against the reference's ``repro/optim/compress.py`` on 8
ranks (the port as ``gloo`` ranks, the reference with 8 forced host
devices: ``tests/torch_ranks.py``), as the reference's own
``tests/test_compress.py`` holds it:

* ``_quant``'s int8 codes and scales equal the reference's;
* the ring ``compressed_psum_vec``, the butterfly, the local-quant form
  and ``compressed_psum_tree`` with error feedback within 1e-6 of the
  reference's outputs (relative to the largest), each within the
  reference's 0.02 (relative norm) of the exact sum;
* the wire bytes the helper counts (ring model) under 0.45x the f32
  all-reduce's, and equal to what the reference reads from XLA's HLO;
* the compressed trainer (``yi-9b`` smoke on a (4, 2) mesh, 15 steps on
  one batch, from the reference's initial parameters): losses within
  1e-3 of the reference's, and learning;
* ``launch/train.py --production`` refuses a world of 8.
"""
import warnings

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.optim import compress as tc

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp

    from repro.optim import compress as jc

OUTS = ("exact", "ring", "butterfly", "local_quant", "tree_a", "tree_b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("compress"))
    ref = tr.run_ref("compress", d, timeout=300)
    return ref, tr.run_port("compress", 8, d, timeout=300)


def test_int8_codes_equal_reference(runs):
    ref, port = runs
    for r in port:
        assert r["q"].dtype == np.int8
        assert np.array_equal(r["q"], ref["q"])
        assert np.array_equal(r["scale"], ref["scale"])


@pytest.mark.parametrize("name", OUTS)
def test_output_against_reference(runs, name):
    ref, port = runs
    want = ref[name]
    for r in port:
        err = float(np.max(np.abs(r[name] - want)))
        assert err <= 1e-6 * float(np.max(np.abs(want))), (name, err)


def test_error_feedback_against_reference(runs):
    """The residual ``flat - dequant(quant(flat))`` is a difference of
    values of order one: held within 1e-6 of the largest of them (one
    rounding of each)."""
    ref, port = runs
    _, tree, ef = tr._compress_inputs()
    flat = np.concatenate([tree["a"].reshape(8, -1), tree["b"]], 1) + ef
    for r in port:
        err = float(np.max(np.abs(r["new_ef"] - ref["new_ef"])))
        assert err <= 1e-6 * float(np.max(np.abs(flat)))


@pytest.mark.parametrize("name", ("ring", "butterfly", "local_quant",
                                  "tree"))
def test_within_two_percent_of_the_exact_sum(runs, name):
    ref, port = runs
    x, tree, ef = tr._compress_inputs()
    for r in port:
        if name == "tree":
            got = np.concatenate([r["tree_a"].reshape(8, -1), r["tree_b"]],
                                 1)
            flat = np.concatenate([tree["a"].reshape(8, -1), tree["b"]],
                                  1) + ef
            exact = np.broadcast_to(flat.sum(0), got.shape)
        else:
            got, exact = r[name], r["exact"]
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 0.02, (name, rel)


def test_wire_bytes_less_than_f32(runs):
    ref, port = runs
    for r in port:
        assert r["wire_int8"] < 0.45 * r["wire_f32"]
        assert r["wire_f32"] == ref["wire_f32"]
        assert r["wire_int8"] == ref["wire_int8"]


def test_compressed_trainer_against_reference(runs):
    ref, port = runs
    want = ref["train_losses"]
    for r in port:
        got = r["train_losses"]
        assert got.shape == want.shape == (tr.TRAIN_STEPS,)
        assert float(np.max(np.abs(got - want))) < 1e-3
        assert got[-1] < got[0] - 0.1, got


def test_production_launcher_refuses_a_small_world(runs):
    _, port = runs
    for r in port:
        assert "needs 512 ranks but the process group has 8" in \
            r["production"]


@pytest.mark.parametrize("seed", range(6))
def test_quant_codes_equal_reference(seed):
    """``_quant`` on the CPU against the reference's, on inputs that put
    values at the rounding halfway points (half to even in both)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4096).astype(np.float32) * 10.0 ** (seed - 3)
    scale = np.float32(np.max(np.abs(x)) / np.float32(127.0))
    x[:64] = (np.arange(64, dtype=np.float32) - 31.5) * scale
    jq, js = jc._quant(jnp.asarray(x))
    tq, ts = tc._quant(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tc._dequant(tq, ts).numpy(),
                          np.asarray(jc._dequant(jq, js)))
