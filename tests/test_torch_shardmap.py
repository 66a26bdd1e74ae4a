"""PyTorch port, the collectives helper (``repro_torch/shardmap.py``):
``shard_map`` and ``psum``/``pmean``/``all_gather``/``all_to_all``/
``ppermute``/``axis_index`` against the reference's ``jax.shard_map``
(through ``repro/shardmap.py``) on the same inputs, outputs and gradients,
on (2, 2) and (2, 4) meshes. The port runs as 4 and then 8 ``gloo`` ranks,
the reference in one process with 8 forced host devices
(``tests/torch_ranks.py``).

The cases cover an operand replicated over an axis (its cotangent summed
there: the ``[3, 3]`` gradient of ``sum(psum(x * (1 + axis_index)))``),
operands cut along an axis and outputs gathered, a sum whose result
leaves the region replicated, gathers tiled and stacked, ``all_to_all``,
``ppermute``, a mean and an index over a pair of axes, and a region
manual over ``"data"`` only. All in float32; outputs and gradients within
1e-6 of the reference's (the two sum in other orders), and every rank's
gradient of a whole operand the same bit for bit.
"""
import numpy as np
import pytest

import torch_ranks as tr
from repro_torch import shardmap as sm
from repro_torch.shardmap import P

CASES = list(tr._cases(P, (2, 2)))
TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shardmap"))
    ref = tr.run_ref("shardmap", d, timeout=240)
    port = {4: tr.run_port("shardmap", 4, d, timeout=240),
            8: tr.run_port("shardmap", 8, d, timeout=240)}
    return ref, port


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), (what, err)


@pytest.mark.parametrize("shape", tr.MESHES, ids=["2x2", "2x4"])
@pytest.mark.parametrize("case", CASES)
def test_collective_against_reference(runs, shape, case):
    ref, port = runs
    want = ref[f"{shape}/{case}"]
    got = port[shape[0] * shape[1]][0][f"{shape}/{case}"]
    for i, (g, w) in enumerate(zip(got["outs"], want["outs"])):
        _close(g, w, f"out {i}")
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        _close(g, w, f"grad {i}")


@pytest.mark.parametrize("shape", tr.MESHES, ids=["2x2", "2x4"])
@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_result(runs, shape, case):
    """Outside the region every operand and output is whole on every
    rank, and so is its gradient: no rank's differs (the rules leave no
    rank with a partial sum, and no ``tp``-fold one)."""
    _, port = runs
    results = [r[f"{shape}/{case}"] for r in port[shape[0] * shape[1]]]
    for r in results[1:]:
        for a, b in zip(r["outs"] + r["grads"],
                        results[0]["outs"] + results[0]["grads"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", tr.MESHES, ids=["2x2", "2x4"])
def test_replicated_operand_gradient_is_three(runs, shape):
    """``grad(sum(psum(x * (1 + axis_index("model")), "model")))`` for a
    ``P()`` operand on a model axis of 2 (the (2, 2) mesh) is 1 + 2 = 3
    everywhere, as JAX's; on a model axis of 4, 1 + 2 + 3 + 4 = 10."""
    ref, port = runs
    tp = shape[1]
    want = np.full(2, tp * (tp + 1) / 2, np.float32)
    key = f"{shape}/psum_index"
    assert np.array_equal(ref[key]["grads"][0], want)
    for r in port[shape[0] * shape[1]]:
        assert np.array_equal(r[key]["grads"][0], want)


def test_dtensor_operand(runs):
    """A ``DTensor`` operand is redistributed to its spec and taken apart
    by ``to_local``: the plain tensors' outputs, and its gradient (placed
    as the operand, ``Partial`` over the axis its spec leaves out)
    gathers to the reference's."""
    ref, port = runs
    want = ref["(2, 2)/matmul"]
    for r in port[4]:
        for g, w in zip(r["dtensor"]["outs"], want["outs"]):
            _close(g, w, "dtensor out")
        _close(r["dtensor"]["w_grad"], want["grads"][1], "dtensor grad")


def test_torch_distributed_nn_transposes_otherwise(runs):
    """Why the helper has its own autograd: ``torch.distributed.nn``'s
    all-reduce over a model axis of 2 gives ``sum(all_reduce(y))`` the
    gradient 2 (its backward an all-reduce), where a region whose output
    leaves replicated gives each rank 1/2 of the cotangent and the sum's
    backward adds them back to 1."""
    _, port = runs
    for r in port[4]:
        assert np.array_equal(r["dist_nn"], np.full(2, 2.0, np.float32))


def test_wire_bytes_count_each_collective(runs):
    """The ring-model bytes a rank sent: the forward all-reduce of
    ``psum_index`` (2 x 8 B x (n - 1) / n) and its backward's."""
    _, port = runs
    wire = port[4][0]["(2, 2)/psum_index"]["wire"]
    # forward psum and its backward psum over model (n = 2), plus the
    # operand's cotangent summed over data and model on the way out
    assert wire == {"all-reduce": 4 * 2 * 8 * (2 - 1) / 2}


def test_all_gather_backward_is_a_reduce_scatter(runs):
    """``gather_tiled`` on (2, 2), its operand block 2 x 3 f32 (24 B): the
    forward all-gather over model (24 B), the backward's reduce-scatter of
    the 4 x 3 cotangent (48 B x (n - 1) / n), and the operand's cotangent
    summed over data (2 x 24 B x (n - 1) / n) and gathered over model
    (24 B) on the way out; no all-reduce stands in for the
    reduce-scatter."""
    _, port = runs
    wire = port[4][0]["(2, 2)/gather_tiled"]["wire"]
    assert wire == {"all-gather": 24 + 24, "reduce-scatter": 48 / 2,
                    "all-reduce": 2 * 24 / 2}


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP

    for entries in ((), (None,), ("data", None), (("data",), None, "model"),
                    (("pod", "data"), None), (None, ("model",)), ((),)):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert isinstance(P("data"), tuple) and repr(P("a")) == "P('a',)"


def test_collectives_need_a_region():
    x = np.ones(2, np.float32)
    for fn in (lambda: sm.psum(x, "model"), lambda: sm.axis_index("data"),
               lambda: sm.axis_size(("data", "model")),
               lambda: sm.ppermute(x, "model", [(0, 1)])):
        with pytest.raises(NameError, match="unbound axis name"):
            fn()
    # an empty tuple of axes sums over nothing, as JAX's
    assert sm.psum(x, ()) is x and sm.pmean(x, ()) is x
    assert sm.pvary(x, ("model",)) is x
    assert sm.PARTIAL_AUTO_PPERMUTE_OK is True
