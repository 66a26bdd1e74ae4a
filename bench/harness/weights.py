"""Seeded random weights, drawn by the benchmark on the device in the type
they are served in: one ``torch.randn`` a leaf of the parameter tree that
the port's schema names (each stacked leaf holds every layer at once), so
a full-size model takes a few dozen large calls.

The scales are the benchmark's own: a matrix ``N(0, 1/fan_in)`` (fan-in is
its second-to-last axis), an embedding ``N(0, 1)``, a norm's scale
``1 + N(0, 0.1^2)`` (so that the reference has to apply it), a bias zero.
Program and reference are handed the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

#: (shape, kind) of one leaf, where kind is matrix | embedding | scale | bias
Leaf = Tuple[Tuple[int, ...], str]


def _draw(shape, kind: str, gen: torch.Generator, dtype: torch.dtype,
          device) -> torch.Tensor:
    if kind == "bias":
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if kind == "matrix":
        return x.mul_(shape[-2] ** -0.5)
    if kind == "embedding":
        return x
    if kind == "scale":
        return x.mul_(0.1).add_(1.0)
    raise ValueError(f"unknown leaf kind {kind!r}")


def draw(layout: Dict[str, Any], seed: int, dtype: torch.dtype,
         device) -> Dict[str, Any]:
    """A tree of tensors with ``layout``'s structure; each leaf of
    ``layout`` is a :data:`Leaf`. Leaves are drawn in sorted key order
    from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        shape, kind = node
        return _draw(tuple(shape), kind, gen, dtype, device)

    return walk(layout)

