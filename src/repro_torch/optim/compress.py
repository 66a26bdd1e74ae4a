"""int8 all-reduce for gradients, the cross-pod wire-byte reducer (port of
``repro/optim/compress.py``).

A ring reduce-scatter + all-gather with int8 payloads (per-block f32
scales sent alongside, re-quantized each hop): per-rank wire bytes about
2·size·1 B against about 8·size for the f32 ring all-reduce, applied
hierarchically (f32 over the fast intra-pod ``"data"`` axis, int8 over
the slow ``"pod"`` axis). The butterfly form keeps each leaf whole and is
what the trainer uses (``make_compressed_grad_fn``); the local-quant form
has the butterfly's numbers over an f32 sum.

Runs inside a ``shardmap.shard_map`` region manual over the data axes;
``shardmap.wire_bytes`` counts what each collective puts on the wire.
Error feedback (``ef``) is available for step-over-step bias correction.
Every division here is by a tensor, so CUDA and the CPU round alike.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import shardmap as sm
from repro_torch.model.layers import tree_leaves, tree_map, value_and_grad
from repro_torch.shardmap import P, axis_size, shard_map


def _div(x: torch.Tensor, n) -> torch.Tensor:
    return x / torch.full_like(x, float(n))


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and its scale (max |x| / 127, shape (1,));
    rounding half to even."""
    scale = _div(torch.clamp(torch.max(torch.abs(x)), min=1e-20), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(1)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_vec(x: torch.Tensor, axis: str) -> torch.Tensor:
    """int8 ring all-reduce of a flat f32 vector inside a manual region."""
    n = axis_size(axis)
    if n == 1:
        return x
    idx = sm.axis_index(axis)
    size = x.numel()
    m = -(-size // n)
    xp = torch.nn.functional.pad(x.reshape(-1), (0, n * m - size)).reshape(
        n, m)
    perm = [(i, (i + 1) % n) for i in range(n)]

    # ---- ring reduce-scatter (int8 wire, requantized partial sums) -------
    cur = xp[idx]                                      # partial of block idx
    for s in range(n - 1):
        q, sc = _quant(cur)
        q = sm.ppermute(q, axis, perm)
        sc = sm.ppermute(sc, axis, perm)
        rb = (idx - s - 1) % n
        cur = _dequant(q, sc) + xp[rb]
    own = (idx + 1) % n                                # block this rank owns

    # ---- ring all-gather of the reduced blocks (int8 wire) ---------------
    out = torch.zeros((n, m), dtype=torch.float32, device=x.device)
    q, sc = _quant(cur)
    out[own] = _dequant(q, sc)
    for s in range(n - 1):
        q = sm.ppermute(q, axis, perm)
        sc = sm.ppermute(sc, axis, perm)
        blk = (own - s - 1) % n
        out[blk] = _dequant(q, sc)
    return out.reshape(-1)[:size].reshape(x.shape)


def compressed_psum_tree(tree: Any, axis: str,
                         ef: Optional[torch.Tensor] = None
                         ) -> Tuple[Any, Optional[torch.Tensor]]:
    """Flatten a gradient tree into one vector, ring-reduce it, unflatten.

    Returns (summed_tree, new_ef). With ``ef`` the local quantization error
    of the *input* quantization is fed back next step (error feedback).
    """
    leaves = tree_leaves(tree)
    flat = torch.cat([t.to(torch.float32).reshape(-1) for t in leaves])
    if ef is not None:
        flat = flat + ef
    summed = compressed_psum_vec(flat, axis)
    new_ef = None
    if ef is not None:
        # residual = what this rank failed to contribute exactly
        q, sc = _quant(flat)
        new_ef = flat - _dequant(q, sc)
    outs, off = [], 0
    for t in leaves:
        outs.append(summed[off: off + t.numel()].reshape(t.shape))
        off += t.numel()
    it = iter(outs)
    return tree_map(lambda _: next(it), tree), new_ef


def compressed_psum_butterfly(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Recursive-doubling (butterfly) all-reduce with int8 payloads: never
    reshapes the operand; log2(n)·size·1 B on the wire."""
    n = axis_size(axis)
    if n == 1:
        return x
    acc = x.to(torch.float32)
    r = 1
    while r < n:
        perm = [(i, i ^ r) for i in range(n)]
        q, sc = _quant(acc)
        q = sm.ppermute(q, axis, perm)
        sc = sm.ppermute(sc, axis, perm)
        acc = acc + _dequant(q, sc)
        r <<= 1
    return acc


def compressed_psum_tree_butterfly(tree: Any, axis: str) -> Any:
    return tree_map(lambda g: compressed_psum_butterfly(g, axis), tree)


def compressed_psum_local_quant(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The int8 all-reduce's numbers over an f32 psum: each rank rounds its
    contribution through the codes the butterfly would send, then the
    dequantized values are summed (sum_i scale_i·q_i)."""
    if axis_size(axis) == 1:
        return x
    q, sc = _quant(x)
    return sm.psum(_dequant(q, sc), axis)


def compressed_psum_tree_local_quant(tree: Any, axis: str) -> Any:
    return tree_map(lambda g: compressed_psum_local_quant(g, axis), tree)


def data_parallel_grad_fn(loss_fn, mesh, mesh_cfg, batch_pspec_tree,
                          reduce_grads):
    """``(params, batch) -> (loss, metrics, grads)`` in a region manual
    over the data axes: the batch split (``batch_pspec_tree``: a
    :class:`~repro_torch.shardmap.P` per batch entry), each rank's
    gradient taken on its part and reduced by ``reduce_grads(grads,
    dp_axes)``, the loss and metrics averaged over the data axes."""
    dp_axes = tuple(mesh_cfg.dp_axes)
    grad_fn = value_and_grad(loss_fn, has_aux=True)

    def local_step(params, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        grads = reduce_grads(grads, dp_axes)
        loss = sm.pmean(loss, dp_axes)
        metrics = tree_map(lambda v: sm.pmean(v, dp_axes), metrics)
        return loss, metrics, grads

    in_specs = (P(), batch_pspec_tree)
    out_specs = (P(), P(), P())
    return shard_map(local_step, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, axis_names=set(dp_axes),
                     check_vma=False)


def f32_mean_tree(grads, dp_axes):
    """The f32 all-reduce: each leaf summed over the data axes, then
    divided by their size."""
    n = axis_size(dp_axes)
    return tree_map(lambda g: _div(sm.psum(g, dp_axes), n), grads)


def int8_mean_tree(grads, dp_axes):
    """The hierarchical reduction: an f32 psum over the inner data axes,
    the int8 butterfly over the outermost, then the reference's
    divisions."""
    if len(dp_axes) > 1:
        grads = tree_map(lambda g: sm.psum(g, dp_axes[1:]), grads)
    grads = compressed_psum_tree_butterfly(grads, dp_axes[0])
    grads = tree_map(lambda g: _div(g, axis_size(dp_axes[0])), grads)
    if len(dp_axes) > 1:
        grads = tree_map(lambda g: _div(g, axis_size(dp_axes[1:][0])),
                         grads)
    return grads


def make_compressed_grad_fn(loss_fn, mesh, mesh_cfg, batch_pspec_tree):
    """:func:`data_parallel_grad_fn` with :func:`int8_mean_tree`, the
    reference's compressed gradient: manual over the data axes."""
    return data_parallel_grad_fn(loss_fn, mesh, mesh_cfg, batch_pspec_tree,
                                 int8_mean_tree)
