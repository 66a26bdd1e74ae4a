"""PyTorch port, post-training int8 quantization (``quant/ptq.py``) and the
int8 carry of ``convert.py``: codes and scales equal to the JAX package's
on the same weights, the same tree structure, the oracle ``int8_matmul_ref``,
and a reference ``Int8Params`` carried across and fed to the port's
``quant_matmul``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul.ops import quant_matmul as j_quant_matmul
from repro.quant.ptq import Int8Params as JInt8Params
from repro.quant.ptq import dequantize_params as j_dequantize_params
from repro.quant.ptq import int8_matmul_ref as j_int8_matmul_ref
from repro.quant.ptq import quantize_params_int8 as j_quantize_params_int8
from repro_torch.convert import int8_params_from_jax, to_torch
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.model.layers import tree_leaves
from repro_torch.quant.ptq import (Int8Params, dequantize_params,
                                   int8_matmul_ref, quantize_params_int8)


def _tree(seed: int = 0):
    """A nested weight tree: 2-D and 3-D float leaves are quantized, the
    1-D bias and the int table are kept, as the reference decides."""
    rng = np.random.default_rng(seed)
    return {"mlp": [{"w_up": rng.standard_normal((64, 96)).astype(np.float32),
                     "b": rng.standard_normal(96).astype(np.float32)},
                    {"w_down": (rng.standard_normal((96, 64)) * 3)
                     .astype(np.float32)}],
            "experts": rng.standard_normal((4, 16, 8)).astype(np.float32),
            "table": np.arange(12, dtype=np.int32).reshape(3, 4)}


def _to(fn, tree):
    if isinstance(tree, dict):
        return {k: _to(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(fn, v) for v in tree]
    return fn(tree)


def _same(port, ref):
    """Same structure (None where None) and equal leaves."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _same(p, r)
    elif ref is None:
        assert port is None
    else:
        got = port.numpy() if isinstance(port, torch.Tensor) else port
        want = np.asarray(ref)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_codes_and_scales_equal_the_reference():
    tree = _tree()
    ip = quantize_params_int8(_to(torch.from_numpy, tree))
    jip = j_quantize_params_int8(_to(jnp.asarray, tree))
    _same(ip.q, jip.q)
    _same(ip.scale, jip.scale)
    _same(ip.skipped, jip.skipped)
    assert ip.q["mlp"][0]["w_up"].dtype == torch.int8
    assert ip.scale["experts"].shape == (1, 1, 8)
    assert ip.q["table"] is None and ip.skipped["mlp"][0]["w_up"] is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_equals_the_reference(dtype):
    tree = _tree(1)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    got = dequantize_params(quantize_params_int8(_to(torch.from_numpy, tree)),
                            dtype)
    want = j_dequantize_params(j_quantize_params_int8(_to(jnp.asarray, tree)),
                               jdtype)
    for g, w in zip(tree_leaves(got), tree_leaves(_to(np.asarray, want))):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    # the quantized leaves come back in ``dtype``; the skipped keep theirs
    assert got["mlp"][0]["w_up"].dtype == got["experts"].dtype == dtype
    assert got["mlp"][0]["b"].dtype == torch.float32
    assert got["table"].dtype == torch.int32


@pytest.mark.parametrize("act_amax", [0.0, 2.5])
def test_int8_matmul_oracle_equals_the_reference(act_amax):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    ip = quantize_params_int8({"w": torch.from_numpy(w)})
    jip = j_quantize_params_int8({"w": jnp.asarray(w)})
    got = int8_matmul_ref(torch.from_numpy(x), ip.q["w"], ip.scale["w"],
                          act_amax)
    want = j_int8_matmul_ref(jnp.asarray(x), jip.q["w"], jip.scale["w"],
                             act_amax)
    assert got.shape == (3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_carries_the_reference_int8_tree():
    tree = _tree(3)
    jip = j_quantize_params_int8(_to(jnp.asarray, tree))
    ip = int8_params_from_jax(jip)
    assert isinstance(ip, Int8Params)
    _same(ip.q, jip.q)
    _same(ip.scale, jip.scale)
    _same(ip.skipped, jip.skipped)
    assert isinstance(ip.q["mlp"][1]["w_down"], np.ndarray)
    tip = to_torch(ip, device="cpu")
    assert tip.q["mlp"][1]["w_down"].dtype == torch.int8
    assert tip.skipped["table"].dtype == torch.int32
    # the carried weights drive the port's B4 as the reference's drive B4
    x = np.random.default_rng(4).standard_normal((16, 96)).astype(np.float32)
    got = quant_matmul(torch.from_numpy(x), tip.q["mlp"][1]["w_down"],
                       tip.scale["mlp"][1]["w_down"])
    want = j_quant_matmul(jnp.asarray(x), jip.q["mlp"][1]["w_down"],
                          jip.scale["mlp"][1]["w_down"])
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-3


def test_convert_refuses_a_malformed_int8_tree():
    jip = j_quantize_params_int8({"w": jnp.ones((8, 4)),
                                  "b": jnp.ones(4)})
    bad_codes = JInt8Params(q={"w": np.ones((8, 4), np.int16), "b": None},
                            scale=jip.scale, skipped=jip.skipped)
    with pytest.raises(ValueError, match="int8.*int16"):
        int8_params_from_jax(bad_codes)
    bad_scale = JInt8Params(q=jip.q, scale={"w": np.ones((1, 4), np.float64),
                                            "b": None}, skipped=jip.skipped)
    with pytest.raises(ValueError, match="float32.*float64"):
        int8_params_from_jax(bad_scale)
    bad_keys = JInt8Params(q=jip.q, scale={"w": jip.scale["w"]},
                           skipped=jip.skipped)
    with pytest.raises(KeyError, match="b"):
        int8_params_from_jax(bad_keys)
    with pytest.raises(ValueError, match="no dtype"):
        to_torch(int8_params_from_jax(jip), device="cpu",
                 dtype=torch.float32)


# ---- K-major storage of the codes (B4's tensor-core and decode kernels) -----
def _k_major_strides(t):
    """The strides of a (..., K, N) leaf stored K-major, in elements."""
    *lead, K, N = t.shape
    outer = [int(np.prod(t.shape[i + 1:])) for i in range(len(lead))]
    return tuple(outer) + (1, K)


def _elem_strides(a):
    return tuple(s // a.itemsize for s in a.strides)


def test_quantized_codes_are_stored_k_major_with_the_reference_values():
    tree = _tree(5)
    ip = quantize_params_int8(_to(torch.from_numpy, tree))
    jip = j_quantize_params_int8(_to(jnp.asarray, tree))
    _same(ip.q, jip.q)                           # values: the reference's
    for path, (K, N) in ((("mlp", 0, "w_up"), (64, 96)),
                         (("mlp", 1, "w_down"), (96, 64))):
        codes = ip.q[path[0]][path[1]][path[2]]
        assert codes.shape == (K, N) and codes.stride() == (1, K)
    # a stacked leaf: each (K, N) slice K-major, the slices one after another
    assert ip.q["experts"].shape == (4, 16, 8)
    assert ip.q["experts"].stride() == (128, 1, 16)
    assert ip.q["experts"][2].stride() == (1, 16)


def test_convert_stores_the_reference_codes_k_major():
    tree = _tree(6)
    jip = j_quantize_params_int8(_to(jnp.asarray, tree))
    ip = int8_params_from_jax(jip)
    _same(ip.q, jip.q)
    for codes in tree_leaves(ip.q):
        assert _elem_strides(codes) == _k_major_strides(codes)
    # to_torch keeps the layout (``meta`` goes through the same copy to a
    # device that CUDA does; the card test repeats it on the card)
    for device in ("cpu", "meta"):
        tip = to_torch(ip, device=device)
        for codes in tree_leaves(tip.q):
            assert codes.dtype == torch.int8
            assert codes.stride() == _k_major_strides(codes)
    tip = to_torch(ip, device="cpu")
    _same(tip.q, jip.q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_and_the_oracle_read_the_codes_by_value(dtype):
    """K-major and row-major copies of the same codes dequantize and
    multiply to the same bits, and dequantize to row-major tensors."""
    tree = _tree(7)
    ip = quantize_params_int8(_to(torch.from_numpy, tree))
    row_major = Int8Params(
        q=_to(lambda t: t if t is None else t.contiguous(), ip.q),
        scale=ip.scale, skipped=ip.skipped)
    assert row_major.q["mlp"][0]["w_up"].stride() == (96, 1)
    for g, w in zip(tree_leaves(dequantize_params(ip, dtype)),
                    tree_leaves(dequantize_params(row_major, dtype))):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert g.is_contiguous() and w.is_contiguous()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (5, 64)).astype(np.float32))
    got = int8_matmul_ref(x, ip.q["mlp"][0]["w_up"], ip.scale["mlp"][0]["w_up"])
    want = int8_matmul_ref(x, row_major.q["mlp"][0]["w_up"],
                           ip.scale["mlp"][0]["w_up"])
    assert torch.equal(got, want)
