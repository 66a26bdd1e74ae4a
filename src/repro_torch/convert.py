"""Carry trained parameters across from the JAX package.

:func:`params_from_jax` takes the reference's parameter pytree — nested
dicts and lists whose leaves are numpy (or JAX) arrays, e.g.
``{"cells": [{"w", "b"}, ...], "head_w", "head_b"}`` or the conv1d
``{"blocks": [...], ...}`` form — and returns the port's parameter dict:
the same keys, float32 numpy arrays, checked leaf by leaf against the
port's schema for ``cfg``. This is what ``rtl.ir.lower_model`` takes.

It also takes an LM's tree (``{"embed", "g0", ..., "final_norm"}``),
whose groups' leaves carry a leading layer axis: the dense stack, an MoE
model's leading dense group and its MoE group (the f32 ``router``, the
stacked experts, ``shared``), whisper's encoder and decoder groups (the
decoder's ``cross_attn``) with ``enc_norm``, and a frontend's
``frontend`` leaves; :func:`to_torch` then puts a converted tree on a
device for ``model.transformer.apply_model`` and
``runtime.server.Server``. A wrong key or a wrong (stacked) shape raises
with its path.

:func:`int8_params_from_jax` carries the reference's int8 weights
(``repro.quant.ptq.Int8Params``: int8 codes, f32 per-channel scales and the
leaves kept in full precision) across as the port's
:class:`~repro_torch.quant.ptq.Int8Params` of numpy arrays, the codes
stored K-major as ``quant/ptq.py`` stores them, which :func:`to_torch`
puts on a device as they are (codes stay int8, strides are kept).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.types import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.model.layers import is_pspec, tree_map
from repro_torch.quant.ptq import Int8Params


def _convert(tree, schema, path: str):
    if is_pspec(schema):
        arr = np.array(tree, dtype=np.float32)     # copies; reads any array
        if arr.shape != tuple(schema.shape):
            raise ValueError(f"params{path}: shape {arr.shape} != schema "
                             f"{tuple(schema.shape)}")
        return arr
    if isinstance(schema, dict):
        if not isinstance(tree, dict):
            raise TypeError(f"params{path}: expected a dict, got "
                            f"{type(tree).__name__}")
        missing = sorted(set(schema) - set(tree))
        extra = sorted(set(tree) - set(schema))
        if missing or extra:
            raise KeyError(f"params{path}: missing keys {missing}, "
                           f"unexpected keys {extra}")
        return {k: _convert(tree[k], schema[k], f"{path}[{k!r}]")
                for k in schema}
    if not isinstance(tree, (list, tuple)) or len(tree) != len(schema):
        raise ValueError(f"params{path}: expected a list of {len(schema)}, "
                         f"got {type(tree).__name__} of "
                         f"{len(tree) if hasattr(tree, '__len__') else '?'}")
    return [_convert(t, s, f"{path}[{i}]")
            for i, (t, s) in enumerate(zip(tree, schema))]


def params_from_jax(tree, cfg: ModelConfig):
    """The reference's parameter pytree for ``cfg`` -> the port's dict."""
    from repro_torch.model.transformer import param_schema

    return _convert(tree, param_schema(cfg), "")


def int8_params_from_jax(ip) -> Int8Params:
    """The reference's ``Int8Params`` (its ``q``/``scale``/``skipped``
    trees) -> the port's, as numpy arrays, each code leaf (..., K, N)
    stored K-major (strides (..., 1, K) in elements). A code leaf that is
    not int8 or a scale that is not float32 raises ValueError; trees that
    do not match raise where :func:`tree_map` finds the mismatch."""
    q, scale, skipped = (tree_map(np.array, t)
                         for t in (ip.q, ip.scale, ip.skipped))

    def check(codes, s):
        if codes.dtype != np.int8 or s.dtype != np.float32:
            raise ValueError(f"int8 params: codes must be int8 and scales "
                             f"float32, got {codes.dtype}, {s.dtype}")

    tree_map(check, q, scale)
    # stored K-major, as quant/ptq.py stores its own codes
    q = tree_map(lambda a: np.ascontiguousarray(a.swapaxes(-1, -2))
                 .swapaxes(-1, -2) if a.ndim >= 2 else a, q)
    return Int8Params(q=q, scale=scale, skipped=skipped)


def to_torch(tree, device: Optional[Union[str, torch.device]] = None,
             dtype: Optional[torch.dtype] = None):
    """A converted tree of numpy arrays -> tensors on ``device`` (None
    means CUDA), cast to ``dtype`` if given. An :class:`Int8Params` moves
    leaf by leaf with its dtypes kept (``dtype`` must then be None)."""
    dev = resolve_device(device)
    if isinstance(tree, Int8Params):
        if dtype is not None:
            raise ValueError("to_torch: int8 codes keep their dtype; pass "
                             "no dtype with an Int8Params")
        return Int8Params(*(to_torch(t, dev) for t in (
            tree.q, tree.scale, tree.skipped)))
    return tree_map(lambda a: torch.as_tensor(a, device=dev, dtype=dtype),
                    tree)
