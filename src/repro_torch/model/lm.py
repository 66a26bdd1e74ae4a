"""Step functions, input specs and the ``Stepper`` (port of
``repro/model/lm.py``).

The step builders return plain callables: PyTorch runs eagerly, so nothing
is jit-compiled, and the LM decode step updates the cache it is given in
place (its K/V buffers; with ``scan_layers`` every stacked leaf). The
train step of every family is the reference's: the window MSE for
``lstm``/``conv1d``, the (chunked) cross-entropy for the LMs, then AdamW;
``donate=True`` gives the form whose update reuses the parameter and
moment buffers it is given, as the reference's trainer donates them to
``jax.jit``.

Given a ``torch.distributed`` device mesh (``launch/mesh.py``), the steps
run on every rank of it and split the transformer and hybrid families'
compute over ``"model"`` as the reference's layouts place it: each rank
computes its q heads (and its kv heads where they divide the axis), its
columns of every MLP's and the shared experts' hidden width, its block
of a Mamba-2 mixer's ``d_inner`` and heads (``ssm.mixer_splits``), its
block of an RWKV-6 time-mix's heads (``rwkv.time_mix_splits``) and of
its channel-mix's ``d_ff``, and its rows of the vocabulary, and the
partial sums go through ``shardmap.psum`` (``layers.Ctx.split``); the
routed experts go to their ranks through the MoE's ``psum``/``a2a``
dispatches. The leaves computed split are :func:`_model_specs`'; every
other leaf (the norms, the router, the RWKV-6 token-shift mixes and
decay LoRA's first matrix, the frontends) is computed whole on every
rank. The serving steps take the rank's blocks (:func:`model_blocks`),
keep the rank's kv heads, Mamba-2 heads and RWKV-6 ``wkv`` heads in the
cache and give every rank the whole last-position logits; a server's
pool is laid over the data axes by :func:`pool_rows` (a data rank's
decode in :func:`rows_region`, its cache rows by :func:`batch_cut_cache`,
the rule the dry-run's serving cells take too). The train
step takes and returns each rank's blocks of the parameters (their
layouts, ``Stepper.shardings``) and its slices of the moments (ZeRO-1,
``optim/adamw.py``): the batch is split over the data axes (a
``shard_map`` region over them), the loss runs in a nested region over
``"model"`` whose operands are the blocks as ``DTensor``s (a leaf
computed whole gathered over ``"model"``, the rest as they lie), the
cross-entropy takes the logits as each rank's vocabulary columns
(:func:`_ce_sum`: the ``(B, S, V)`` logits are never gathered) and is
the whole batch's (its count of unmasked targets summed over the data
axes; under ``grad_compression`` each data rank's, averaged), the
gradients are reduced over the data axes (an f32 all-reduce, or
``optim/compress.py``'s int8 butterfly under ``grad_compression``), and
the update keeps each rank's slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.types import (MeshConfig, ModelConfig,
                                    ParallelismConfig, ShapeConfig,
                                    torch_dtype)
from repro_torch.device import resolve_device
from repro_torch.model.layers import (Axis, Ctx, Sharding, abstract_params,
                                      axes_of, checkpoint, head_split,
                                      init_params, is_pspec, local_blocks,
                                      placements, pspec, pspecs, shardings,
                                      tree_map, tree_map_pspec,
                                      value_and_grad)
from repro_torch.model.transformer import (apply_model, group_structure,
                                           head_logits, model_cache_schema,
                                           param_schema)
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     adamw_update_, adamw_update_sharded,
                                     opt_state_schema)

__all__ = ["param_schema", "cross_entropy", "chunked_ce_loss",
           "make_loss_fn", "make_train_step", "make_prefill_step",
           "make_decode_step", "model_blocks", "input_specs",
           "batch_pspecs", "pool_rows", "rows_region", "batch_cut_cache",
           "pool_zeros", "Stepper"]

WINDOW_FAMILIES = ("lstm", "conv1d")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce_sum(logits: torch.Tensor, targets: torch.Tensor,
            vocab_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the unmasked positions' CE, their count as int32).
    ``vocab_split``: ``logits`` are this rank's block of the vocabulary
    over ``"model"``; the log-sum-exp is taken over the ranks
    (``shardmap.logsumexp``) and the gold logit comes from the rank that
    holds it (zero elsewhere, then summed). Padded vocabulary columns
    count as in the whole form."""
    mask = targets >= 0
    t = torch.clamp(targets, min=0).long()
    if not vocab_split:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
    else:
        from repro_torch import shardmap as sm

        n = logits.shape[-1]
        lse = sm.logsumexp(logits, "model")
        local = t - sm.axis_index("model") * n
        held = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        gold = sm.psum(torch.where(held, gold[..., 0], 0.0), "model")
    return ((lse - gold) * mask).sum(), mask.sum(dtype=torch.int32)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_split: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V) f32, targets (B, S) int (-1 = masked) ->
    (loss, n_tok); ``vocab_split`` as :func:`_ce_sum`'s."""
    tot, n = _ce_sum(logits, targets, vocab_split)
    n = torch.clamp(n, min=1)
    return tot / n, n


# Positions per CE chunk: bounds live f32 logits to (B, CE_CHUNK, V).
CE_CHUNK = 512


def _chunked_ce_sum(hidden: torch.Tensor, targets: torch.Tensor,
                    head_fn, vocab_split: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ce_sum` over the logits of ``head_fn(hidden)``, a chunk of
    positions at a time (:func:`chunked_ce_loss`)."""
    S = hidden.shape[1]
    ck = min(CE_CHUNK, S)
    chunk_loss = checkpoint(
        lambda h_c, t_c: _ce_sum(head_fn(h_c), t_c, vocab_split))
    tot = n = None
    for i in range(0, S, ck):
        li, ni = chunk_loss(hidden[:, i:i + ck], targets[:, i:i + ck])
        tot, n = (li, ni) if tot is None else (tot + li, n + ni)
    return tot, n


def chunked_ce_loss(hidden: torch.Tensor, targets: torch.Tensor,
                    head_fn, vocab_split: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded LM loss: the (B, S, V) logits tensor is never alive
    at once — each chunk's logits and CE under :func:`checkpoint` (the
    backward recomputes the chunk's logits instead of keeping them); the
    last chunk is ragged. ``vocab_split`` as :func:`_ce_sum`'s."""
    tot, n = _chunked_ce_sum(hidden, targets, head_fn, vocab_split)
    n = torch.clamp(n, min=1)
    return tot / n, n


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _mk_ctx(cfg, mesh_cfg, mode, mesh, par, split=False):
    return Ctx(cfg=cfg, mesh_cfg=mesh_cfg, mode=mode, mesh=mesh, par=par,
               attn_impl=par.attn_impl, split=split)


def _window_apply(cfg: ModelConfig):
    if cfg.family == "lstm":
        from repro_torch.model.lstm import lstm_apply as apply_fn
    else:
        from repro_torch.model.conv1d import conv1d_apply as apply_fn
    return apply_fn


def make_loss_fn(cfg: ModelConfig, mesh_cfg: MeshConfig,
                 par: ParallelismConfig, mesh: Optional[Any] = None,
                 split: bool = False, batch_axes: Tuple[str, ...] = ()):
    """(params, batch) -> (loss, metrics): the window MSE, or the LM's
    cross-entropy (chunked over positions where ``cfg.ce_chunked``) plus
    the auxiliary loss, with ``{"loss", "aux", "n_tok"}``. ``split``: run
    in a region manual over ``"model"`` on the blocks of
    :func:`_model_specs` (``Ctx.split``). ``batch_axes``: the manual axes
    that cut the batch; the CE is then this rank's part of the whole
    batch's, its sum over the count of every rank's unmasked targets
    (``n_tok``), times the axes' size, so that the mean over them
    (``optim/compress.py::data_parallel_grad_fn``) of the loss and of its
    gradient is the whole batch's."""
    if cfg.family in WINDOW_FAMILIES:
        apply_fn = _window_apply(cfg)

        def window_loss(params, batch):
            pred, _ = apply_fn(params, batch["x"], cfg)
            loss = torch.mean(torch.square(pred - batch["y"]))
            return loss, {"loss": loss}

        return window_loss

    def loss_fn(params, batch):
        ctx = _mk_ctx(cfg, mesh_cfg, "train", mesh, par, split)
        hidden, _, aux = apply_model(params, batch, ctx, return_hidden=True)
        vs = head_split(cfg, ctx)
        if cfg.ce_chunked:
            tot, n_tok = _chunked_ce_sum(
                hidden, batch["targets"],
                lambda h: head_logits(params, h, ctx), vs)
        else:
            tot, n_tok = _ce_sum(head_logits(params, hidden, ctx),
                                 batch["targets"], vs)
        if batch_axes:
            from repro_torch import shardmap as sm

            n_tok = sm.psum(n_tok, batch_axes)
            tot = tot * sm.axis_size(batch_axes)
        n_tok = torch.clamp(n_tok, min=1)
        ce = tot / n_tok
        return ce + aux, {"loss": ce, "aux": aux, "n_tok": n_tok}

    return loss_fn


def make_train_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                    par: ParallelismConfig, opt_cfg: AdamWConfig,
                    mesh: Optional[Any] = None, donate: bool = False):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    ``donate=True``: params' and opt_state' are the buffers of params and
    opt_state, updated in place (:func:`~repro_torch.optim.adamw.
    adamw_update_`), so a step holds one copy of the state; the numbers are
    the same bit for bit. With ``mesh``: the step of every rank of it, on
    its blocks (see the module doc); the int8 gradient reduction runs only
    on a mesh of more than one rank, as the reference's.
    """
    if mesh is not None:
        return _mesh_train_step(cfg, mesh_cfg, par, opt_cfg, mesh, donate)
    grad_fn = value_and_grad(make_loss_fn(cfg, mesh_cfg, par), has_aux=True)
    update = adamw_update_ if donate else adamw_update

    def step(params, opt_state, batch):
        (_, metrics), grads = grad_fn(params, batch)
        new_params, new_opt, info = update(grads, opt_state, params,
                                           opt_cfg)
        return new_params, new_opt, dict(metrics, **info)

    return step


#: a block's subtrees computed split over "model": a transformer block's
#: attentions and MLP, zamba2's shared block's
_SPLIT_BLOCKS = ("attn", "self_attn", "cross_attn", "mlp")


def _model_specs(cfg: ModelConfig, schema, tp: int, split: bool = True):
    """The block of each parameter leaf the mesh steps compute with, in
    their region over a ``"model"`` axis of ``tp`` ranks (``schema``'s
    tp): its layout (``P(*s.pspec)``) for the embedding and head, every
    attention and MLP of a transformer block and of zamba2's shared
    block, the MoE's shared experts, a Mamba-2 mixer where it splits
    (``ssm.mixer_splits``), an RWKV-6 time-mix where its heads split
    (``rwkv.time_mix_splits``), every RWKV-6 channel-mix (its ``d_ff``
    leaves name ``"model"`` only where ``d_ff`` splits), and a routed
    expert stack that the MoE's ``psum``/``a2a`` consume split
    (``PSpec.experts``); ``P()`` (whole) for every other leaf: the norms,
    the router, the shared block's ``out_proj``, a Mamba-2 mixer or
    RWKV-6 time-mix that does not split, the frontends. A laid subtree's
    leaves whose layout names no axis (the RWKV-6 ``maa_*``) are whole
    all the same. ``split=False``: the expert stacks alone keep their
    layout (every rank computing the rest whole)."""
    from repro_torch.model.rwkv import time_mix_splits
    from repro_torch.model.ssm import mixer_splits
    from repro_torch.shardmap import P

    ep = cfg.moe is not None and cfg.moe.impl != "dense"

    def specs(tree, laid=False):
        return tree_map(lambda s: P(*s.pspec) if laid or (ep and s.experts)
                        else P(), tree, is_leaf=is_pspec)

    if not split or cfg.family in WINDOW_FAMILIES:
        return specs(schema)
    groups = {f"g{gi}" for gi in range(len(group_structure(cfg)))}
    laid_mixers = {"mamba": cfg.ssm is not None and mixer_splits(cfg, tp),
                   "att": cfg.rwkv is not None and time_mix_splits(cfg, tp),
                   "ffn": cfg.rwkv is not None}
    out = {}
    for key, sub in schema.items():
        if key == "embed":
            out[key] = specs(sub, laid=True)
        elif key in groups or key == "shared":
            out[key] = {k: specs(v, laid=k in _SPLIT_BLOCKS
                                 or laid_mixers.get(k, False))
                        for k, v in sub.items()}
            if "moe" in sub and "shared" in sub["moe"]:
                out[key]["moe"]["shared"] = specs(sub["moe"]["shared"],
                                                  laid=True)
        else:
            out[key] = specs(sub)
    return out


def model_blocks(params, cfg: ModelConfig, mesh_cfg: MeshConfig, mesh):
    """This rank's blocks of the whole ``params`` as the mesh steps
    compute with them (:func:`_model_specs`; ``layers.local_blocks``): a
    copy of each leaf split over ``"model"``, every other leaf itself."""
    tp = mesh_cfg.axis_size("model")
    schema = param_schema(cfg, tp=tp)
    blocks = tree_map(lambda s, sp: Sharding(mesh, placements(mesh, sp)),
                      schema, _model_specs(cfg, schema, tp), is_leaf=is_pspec)
    return local_blocks(params, blocks)


def _mesh_grad_fn(cfg, mesh_cfg, par, mesh, split: bool = True):
    """``(blocks, batch) -> (loss, metrics, grads)`` of the mesh train
    step (see the module doc), the gradients as the parameters' blocks,
    reduced over the data axes. ``split=False``: every rank computes the
    step whole (:func:`_model_specs`), the form the split one is held
    to."""
    from torch.distributed.tensor import DTensor

    from repro_torch import shardmap as sm
    from repro_torch.optim.compress import (data_parallel_grad_fn,
                                            f32_mean_tree, int8_mean_tree)
    from repro_torch.shardmap import P

    if tuple(mesh.mesh_dim_names) != tuple(mesh_cfg.axes):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} are not "
                         f"{mesh_cfg.axes}")
    tp = mesh_cfg.axis_size("model")
    schema = param_schema(cfg, tp=tp)
    tp_mesh = mesh["model"]
    # a parameter layout names "model" alone (placements raises otherwise)
    stored = tree_map(lambda s: placements(tp_mesh, s.pspec), schema,
                      is_leaf=is_pspec)
    specs = _model_specs(cfg, schema, tp, split)
    # the int8 reduction needs more than one rank, as the reference's
    compressed = par.grad_compression and mesh.size() > 1
    reduce_grads = int8_mean_tree if compressed else f32_mean_tree

    def local_loss_fn(ba):
        """The loss of a data rank's part of the batch, cut over the axes
        ``ba``: the whole batch's CE where the gradients are reduced in
        f32, as the reference's step takes it; under the int8 reduction
        the part's own, whose mean over the data ranks the reference's
        compressed step takes."""
        # each leaf enters as a DTensor of its blocks, redistributed to
        # the spec the loss computes with (a leaf computed whole is
        # gathered over "model", its backward a reduce-scatter; the rest
        # enter as they lie)
        model_loss = sm.shard_map(
            make_loss_fn(cfg, mesh_cfg, par, mesh, split,
                         () if compressed or ba is None else ba),
            mesh=mesh, in_specs=(specs, P()), out_specs=P(),
            axis_names={"model"})

        def local_loss(params, batch):
            leaves = tree_map(
                lambda t, pl: DTensor.from_local(t, tp_mesh, pl,
                                                 run_check=False),
                params, stored)
            return model_loss(leaves, batch)

        return local_loss

    def grad_fn(params, batch):
        gb = next(iter(batch.values())).shape[0]
        ba = _batch_axis(mesh_cfg, gb)
        bspec = {k: P(ba, *([None] * (v.ndim - 1)))
                 for k, v in batch.items()}
        return data_parallel_grad_fn(local_loss_fn(ba), mesh, mesh_cfg,
                                     bspec, reduce_grads)(params, batch)

    return grad_fn


def _mesh_train_step(cfg, mesh_cfg, par, opt_cfg, mesh, donate,
                     split: bool = True):
    """The mesh train step (module doc); ``split`` as
    :func:`_mesh_grad_fn`'s."""
    from repro_torch import shardmap as sm

    schema = param_schema(cfg, tp=mesh_cfg.axis_size("model"))
    grad_fn = _mesh_grad_fn(cfg, mesh_cfg, par, mesh, split)

    def step(params, opt_state, batch):
        _, metrics, grads = grad_fn(params, batch)
        with sm.region(mesh):
            new_params, new_opt, info = adamw_update_sharded(
                grads, opt_state, params, opt_cfg, schema=schema,
                mesh_cfg=mesh_cfg, donate=donate)
        return new_params, new_opt, dict(metrics, **info)

    return step


def _serving_region(mesh):
    """The serving steps' region manual over ``"model"`` (their blocks are
    the rank's already: ``shardmap.region``; nothing is differentiated)."""
    if mesh is None:
        return contextlib.nullcontext()
    from repro_torch import shardmap as sm

    return sm.region(mesh, ("model",))


def _last_logits(logits: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The last position's logits, whole on every rank: gathered over
    ``"model"`` where the rank holds its vocabulary columns, so every
    rank samples the same token from the same numbers."""
    last = logits[:, -1]
    if head_split(ctx.cfg, ctx):
        from repro_torch import shardmap as sm

        last = sm.all_gather(last, "model", axis=-1, tiled=True)
    return last


def make_prefill_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                      par: ParallelismConfig, mesh: Optional[Any] = None):
    """(params, batch) -> (last_logits (B, V) f32, cache). With ``mesh``,
    ``params`` are this rank's blocks (:func:`model_blocks`) and the cache
    holds its kv heads (module doc).

    For the window families "prefill" is one window inference: (params,
    batch) -> (pred (B, out_features), state), what the RTL target lowers.
    """
    if cfg.family in WINDOW_FAMILIES:
        apply_fn = _window_apply(cfg)

        def window_step(params, batch):
            return apply_fn(params, batch["x"], cfg)

        return window_step

    def step(params, batch):
        ctx = _mk_ctx(cfg, mesh_cfg, "prefill", mesh, par, mesh is not None)
        with _serving_region(mesh):
            logits, cache, _ = apply_model(params, batch, ctx)
            return _last_logits(logits, ctx), cache

    return step


def make_decode_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                     par: ParallelismConfig, mesh: Optional[Any] = None):
    """(params, tokens (B, 1), cache) -> (logits (B, V) f32, cache'); the
    K/V buffers of ``cache`` are updated in place and returned in cache'.
    With ``mesh`` as :func:`make_prefill_step`'s."""

    def step(params, tokens, cache):
        ctx = _mk_ctx(cfg, mesh_cfg, "decode", mesh, par, mesh is not None)
        with _serving_region(mesh):
            logits, new_cache, _ = apply_model(params, {"tokens": tokens},
                                               ctx, cache=cache)
            return _last_logits(logits, ctx), new_cache

    return step


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in WINDOW_FAMILIES:
        c = cfg.lstm if cfg.family == "lstm" else cfg.conv1d
        d_in = c.in_features if cfg.family == "lstm" else c.channels
        return {"x": ((B, c.seq_len, d_in), torch.float32),
                "y": ((B, c.out_features), torch.float32)}
    specs = {"tokens": ((B, 1 if shape.kind == "decode" else S),
                        torch.int32)}
    if shape.kind == "train":
        specs["targets"] = ((B, S), torch.int32)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            specs["patches"] = ((B, cfg.n_frontend_tokens, cfg.frontend_dim),
                                torch.float32)
        if cfg.frontend == "audio":
            specs["frames"] = ((B, cfg.encoder.n_positions,
                                cfg.frontend_dim), torch.float32)
    return specs


def _batch_axis(mesh_cfg: MeshConfig,
                batch: int) -> Optional[Tuple[str, ...]]:
    dp = mesh_cfg.dp_axes
    n = 1
    for a in dp:
        n *= mesh_cfg.axis_size(a)
    return dp if (n > 1 and batch % n == 0) else None


def pool_rows(mesh_cfg: MeshConfig, batch_slots: int
              ) -> Optional[Tuple[Tuple[str, ...], int]]:
    """The serving pool's layout over the data axes, the reference's
    batch layout (:func:`_batch_axis`): ``(axes, k)`` where the data axes
    (``pod`` major) number more than one rank and divide ``batch_slots``,
    data rank ``d`` of them holding slots ``[d·k, (d+1)·k)`` (``P(axes)``'s
    blocks); None otherwise, every data rank holding the whole pool."""
    axes = _batch_axis(mesh_cfg, batch_slots)
    if axes is None:
        return None
    return axes, batch_slots // math.prod(mesh_cfg.axis_size(a)
                                          for a in axes)


def rows_region(mesh, axes: Tuple[str, ...], rows: int):
    """A region manual over the data axes ``axes`` whose operands hold
    ``rows`` rows of the batch those axes cut: a data rank's serving step
    on its rows (``Server(mesh=)``'s ticks, the dry-run's serving cells).
    ``Ctx.constrain`` checks the activations' batch against ``rows``, and
    the MoE's region does not cut them again."""
    from repro_torch import shardmap as sm

    return sm.region(mesh, axes, batch=((axes, rows),))


def batch_cut_cache(schema, batch_axes, batch: int, stacked: bool):
    """The cache schema with every leaf's batch dim (dim 0, or 1 in the
    stacked layout) cut over ``batch_axes`` as the tokens are: the
    attention caches' ``pos`` rows, which the reference lays whole (XLA
    slices each device's rows out of them), are a data rank's rows in its
    block of the step. The dry-run's serving cells and ``Server(mesh=)``'s
    pool (:func:`pool_zeros`) both take their rows from it."""
    if batch_axes is None:
        return schema
    bd = 1 if stacked else 0

    def cut(s):
        layout = list(s.pspec) + [None] * (len(s.shape) - len(s.pspec))
        if len(s.shape) <= bd or s.shape[bd] != batch or layout[bd]:
            return s
        layout[bd] = batch_axes
        return dataclasses.replace(s, pspec=tuple(layout))

    return tree_map_pspec(cut, schema)


def pool_zeros(cfg: ModelConfig, mesh_cfg: MeshConfig,
               par: ParallelismConfig, batch_slots: int, max_len: int,
               mesh, device: torch.device):
    """Zeros of the serving pool's cache as this rank of ``mesh`` holds
    it, of the shapes and dtypes that a prefill padded to ``max_len``
    gives: its rows (:func:`pool_rows`, cut by :func:`batch_cut_cache`),
    every position, each leaf's heads over ``"model"`` as the serving
    steps hold them (the schema's layout; a Mamba-2 state whole where the
    mixer does not split, ``ssm.mixer_splits``); the compute dtype where
    the schema says bf16. ``Server(mesh=)`` builds a data rank's pool
    from it when the rank's first admission round brings it no request."""
    from repro_torch.model.ssm import mixer_splits

    tp = mesh_cfg.axis_size("model")
    whole_mamba = cfg.ssm is not None and not mixer_splits(cfg, tp)

    def served(entry):
        if entry is None:
            return None
        keep = not (whole_mamba and "ssm" in entry)
        return {k: dataclasses.replace(s, pspec=tuple(
            "model" if keep and "model" in axes_of(a) else None
            for a in s.pspec)) for k, s in entry.items()}

    schema = model_cache_schema(cfg, batch_slots, max_len, mesh_cfg, tp=tp)
    schema = {k: tuple(served(e) for e in v) for k, v in schema.items()}
    rows = pool_rows(mesh_cfg, batch_slots)
    schema = batch_cut_cache(schema, rows and rows[0], batch_slots, False)
    dt = torch_dtype(par.compute_dtype)

    def zeros(s):
        shape = (s.shape if mesh is None else Sharding(
            mesh, placements(mesh, s.pspec)).local_shape_and_offset(
                s.shape)[0])
        return torch.zeros(shape, device=device, dtype=(
            dt if s.dtype == torch.bfloat16 else s.dtype))

    return tree_map_pspec(zeros, schema)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 mesh_cfg: MeshConfig) -> Dict[str, Tuple[Axis, ...]]:
    """The layout of every model input of this cell: the batch over the
    data axes where it divides them."""
    ba = _batch_axis(mesh_cfg, shape.global_batch)
    if cfg.family in WINDOW_FAMILIES:
        return {"x": pspec(ba, None, None), "y": pspec(ba, None)}
    specs = {"tokens": pspec(ba, None)}
    if shape.kind == "train":
        specs["targets"] = pspec(ba, None)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            specs["patches"] = pspec(ba, None, None)
        if cfg.frontend == "audio":
            specs["frames"] = pspec(ba, None, None)
    return specs


@dataclass
class Stepper:
    """Schema, layouts and step functions of one (arch x shape x mesh)
    cell. ``mesh`` is the ``torch.distributed`` device mesh of
    ``mesh_cfg`` (``launch/mesh.py``) or None (one device); with one, the
    train step takes and returns this rank's blocks
    (:meth:`state_shardings`, ``layers.local_blocks``)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh_cfg: MeshConfig
    par: ParallelismConfig
    mesh: Optional[Any] = None
    opt_cfg: AdamWConfig = AdamWConfig()

    def __post_init__(self):
        tp = self.mesh_cfg.axis_size("model")
        self.schema = param_schema(self.cfg, tp=tp)
        self.param_pspecs = pspecs(self.schema)

    def abstract_inputs(self):
        """``meta`` tensors of every input of the cell's step: params,
        and the optimizer state (train) or the cache (decode), and the
        batch."""
        batch = {k: torch.empty(shape, dtype=dtype, device="meta")
                 for k, (shape, dtype) in input_specs(
                     self.cfg, self.shape).items()}
        out = {"params": abstract_params(self.schema), "batch": batch}
        if self.shape.kind == "train":
            out["opt_state"] = abstract_params(
                opt_state_schema(self.schema, self.mesh_cfg))
        elif self.shape.kind == "decode":
            out["cache"] = abstract_params(self.cache_schema())
        return out

    def cache_schema(self):
        tp = self.mesh_cfg.axis_size("model")
        return model_cache_schema(self.cfg, self.shape.global_batch,
                                  self.shape.seq_len, self.mesh_cfg, tp=tp,
                                  stacked=self.par.scan_layers,
                                  seq_shard=self.par.seq_shard_decode)

    def shardings(self, tree_schema):
        """Every leaf's placement on ``self.mesh`` (``layers.Sharding``)."""
        if self.mesh is None:
            raise ValueError("Stepper.shardings needs a mesh "
                             "(launch/mesh.py)")
        return shardings(tree_schema, self.mesh)

    def state_shardings(self):
        """``{"params", "opt"}``: the placement of every leaf of the
        training state on ``self.mesh``, the moments' with ZeRO-1."""
        return {"params": self.shardings(self.schema),
                "opt": self.shardings(opt_state_schema(self.schema,
                                                       self.mesh_cfg))}

    def train_fn(self, donate: bool = False):
        return make_train_step(self.cfg, self.mesh_cfg, self.par,
                               self.opt_cfg, self.mesh, donate)

    def prefill_fn(self):
        return make_prefill_step(self.cfg, self.mesh_cfg, self.par,
                                 self.mesh)

    def decode_fn(self):
        return make_decode_step(self.cfg, self.mesh_cfg, self.par,
                                self.mesh)

    def init(self, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = None,
             dtype_override: Optional[torch.dtype] = None):
        """Seeded random parameters drawn on ``device`` (None means CUDA)
        by a ``torch.Generator``. Parameters only: the reference's ``init``
        also returns the optimizer state, which at Yi-9B's width (72 GB of
        f32 moments beside 18 GB of bf16 weights) would not fit on the
        card; a trainer takes it from ``optim.adamw.init_opt_state``."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(self.schema, gen, dtype_override)
