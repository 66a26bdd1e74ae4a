"""Shared layers + the parameter-schema machinery (port of
``repro/model/layers.py``).

A model's parameters are described once as nested dicts (and tuples or
lists) of :class:`PSpec` leaves: shape, layout, dtype, init.
:func:`init_params` draws real tensors from the same schema that
``convert.params_from_jax`` checks a carried-over tree against;
:func:`abstract_params` gives ``meta`` tensors of it and :func:`shardings`
each leaf's placement on a ``torch.distributed`` device mesh.

A leaf's layout (``PSpec.pspec``) is the reference's partition spec as a
tuple: one entry per leading dim, each None (replicated), a mesh axis name
or a tuple of them (the dim split over their product, the first axis
major); missing trailing entries are None. :func:`local_blocks` cuts a
whole tree to a rank's blocks; the mesh train step (``model/lm.py``) and
the MoE's expert parallelism (``model/moe.py``) compute on them through
``shardmap.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.types import (MeshConfig, ModelConfig,
                                    ParallelismConfig, torch_dtype)

# ---------------------------------------------------------------------------
# Parameter schema
# ---------------------------------------------------------------------------


#: one dim's entry of a layout: replicated, one mesh axis, or several
Axis = Union[None, str, Tuple[str, ...]]


def pspec(*entries: Union[Axis, Sequence[str]]) -> Tuple[Axis, ...]:
    """A layout tuple, as ``tuple(jax.sharding.PartitionSpec(*entries))``
    gives it: a one-axis tuple entry becomes the axis name, an empty one
    None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = None if not e else e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def axes_of(entry: Axis) -> Tuple[str, ...]:
    """The mesh axes one layout entry names, in order."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


@dataclass(frozen=True)
class PSpec:
    """One parameter leaf: shape + layout + dtype + init, the single source
    of truth. ``experts`` marks a routed expert stack, which the MoE's
    ``psum``/``a2a`` dispatches take as each rank's block over
    ``"model"`` (the mesh train step leaves it split, ``model/lm.py``)."""

    shape: Tuple[int, ...]
    pspec: Tuple[Axis, ...] = ()
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default: 1/sqrt(fan_in))
    keep_dtype: bool = False       # no dtype_override (the f32 MoE router)
    experts: bool = False          # a routed expert stack (class doc)


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts/tuples/lists (``None`` is
    kept as is); dict keys are visited in sorted order, as
    ``jax.tree.flatten`` does. ``rest`` are trees of the same structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def _init_leaf(spec: PSpec, gen: torch.Generator,
               dtype_override: Optional[torch.dtype]) -> torch.Tensor:
    dtype = spec.dtype if spec.keep_dtype else dtype_override or spec.dtype
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
    else:                                          # fan-in normal
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=dev)
    return x.mul_(std).to(dtype)


def tree_map_pspec(fn: Callable[[PSpec], Any], schema):
    return tree_map(fn, schema, is_leaf=is_pspec)


def pspecs(schema):
    """The layout of every leaf."""
    return tree_map_pspec(lambda s: s.pspec, schema)


def abstract_params(schema, dtype_override: Optional[torch.dtype] = None):
    """``meta`` tensors of every leaf's shape and dtype (``dtype_override``
    where given, as the reference's ``abstract_params``): no memory. The
    leaves are :class:`PSpec` or tensors."""
    return tree_map_pspec(lambda s: torch.empty(
        s.shape, dtype=dtype_override or s.dtype, device="meta"), schema)


@dataclass(frozen=True)
class Sharding:
    """A leaf's placement on a ``torch.distributed`` device mesh: one
    ``Shard(dim)`` or ``Replicate()`` per mesh dim (the reference's
    ``NamedSharding(mesh, pspec)``). A dim split over several mesh dims is
    split over the first of them in mesh order, then each part over the
    next."""

    mesh: Any                                   # a DeviceMesh
    placements: Tuple[Any, ...]

    def _splits(self, ndim: int):
        """Per tensor dim, the indices of the mesh dims that split it, in
        mesh order."""
        out = [[] for _ in range(ndim)]
        for i, p in enumerate(self.placements):
            if p.is_shard():
                out[p.dim].append(i)
        return out

    def local_shape_and_offset(self, shape: Sequence[int],
                               coordinate: Optional[Sequence[int]] = None
                               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """This rank's (or ``coordinate``'s) block of a ``shape`` leaf: its
        shape and its offset in the global tensor. Parts are
        ``torch.chunk``'s (ceil-sized; the last ones may be short or
        empty), as DTensor's ``Shard`` cuts them."""
        coord = (self.mesh.get_coordinate() if coordinate is None
                 else list(coordinate))
        if coord is None:
            raise ValueError("this rank holds no part of the mesh")
        sizes, offsets = list(shape), [0] * len(shape)
        for d, mesh_dims in enumerate(self._splits(len(shape))):
            for m in mesh_dims:
                n = self.mesh.size(m)
                part = -(-sizes[d] // n)
                start = min(coord[m] * part, sizes[d])
                offsets[d] += start
                sizes[d] = min(part, sizes[d] - start)
        return tuple(sizes), tuple(offsets)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The block shape of a ``shape`` leaf at mesh coordinate 0 (the
        reference's ``NamedSharding.shard_shape``)."""
        return self.local_shape_and_offset(
            shape, [0] * len(self.placements))[0]


def placements(mesh, layout: Sequence[Axis]) -> Tuple[Any, ...]:
    """``layout``'s ``Shard``/``Replicate`` for each dim of ``mesh``
    (named by ``mesh.mesh_dim_names``). An entry of several axes must
    name them in the mesh's order, the one order ``Shard`` expresses (the
    reference's layouts all do: ``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(layout):
        axes = axes_of(entry)
        for axis in axes:
            if axis not in names:
                raise ValueError(f"layout {tuple(layout)} names {axis!r}, "
                                 f"not an axis of the mesh {names}")
            if out[names.index(axis)].is_shard():
                raise ValueError(f"layout {tuple(layout)} uses mesh axis "
                                 f"{axis!r} twice")
            out[names.index(axis)] = Shard(dim)
        if list(axes) != sorted(axes, key=names.index):
            # Shard placements split a dim over mesh dims in mesh order
            raise ValueError(f"layout {tuple(layout)} splits dim {dim} over "
                             f"{axes}, not in the mesh's order {names}")
    return tuple(out)


def shardings(schema, mesh):
    """Every leaf's :class:`Sharding` on ``mesh`` (a ``DeviceMesh`` whose
    dim names are the layouts' axis names)."""
    return tree_map_pspec(
        lambda s: Sharding(mesh, placements(mesh, s.pspec)), schema)


def local_blocks(tree, shardings_tree):
    """This rank's block of every leaf of ``tree`` (whole tensors) under
    ``shardings_tree`` (:func:`shardings`; a None subtree keeps its leaves
    whole): a copy where the leaf is split, the leaf itself where not."""
    def one(t, sh):
        if sh is None:
            return t
        shape, off = sh.local_shape_and_offset(t.shape)
        if tuple(shape) == tuple(t.shape):
            return t
        block = t
        for d, (n, o) in enumerate(zip(shape, off)):
            block = block.narrow(d, o, n)
        return block.clone()

    return _zip_map(one, tree, shardings_tree)


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over ``tree``, ``other`` a tree of the same
    structure whose None subtrees pass None to every leaf below them."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], None if other is None else other[k])
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, t, None if other is None else other[i])
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, other)


def init_params(schema, generator: torch.Generator,
                dtype_override: Optional[torch.dtype] = None):
    """Materialise real tensors from a schema on ``generator.device``,
    leaves drawn one after another from ``generator`` (dict keys in sorted
    order), each in ``dtype_override`` where given, unless its spec keeps
    its dtype. The reference folds a JAX key per leaf, so the two packages
    draw different numbers from one seed: tests carry the reference's
    tensors across with ``convert.params_from_jax`` instead."""
    return tree_map(lambda s: _init_leaf(s, generator, dtype_override),
                    schema, is_leaf=is_pspec)


def value_and_grad(fn: Callable, has_aux: bool = False):
    """``jax.value_and_grad`` for a function of a parameter tree:
    ``(params, *args) -> (fn(params, *args), grads)``, ``grads`` with the
    tree's structure, by ``torch.autograd.grad`` on detached leaves (the
    caller's tensors are not touched); the value comes back detached."""

    def wrapped(params, *args):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        out = fn(p, *args)
        value = out[0] if has_aux else out
        it = iter(torch.autograd.grad(value, tree_leaves(p)))
        grads = tree_map(lambda _: next(it), p)
        return tree_map(lambda t: t.detach() if isinstance(
            t, torch.Tensor) else t, out), grads

    return wrapped


def checkpoint(fn: Callable, save_dots: bool = False) -> Callable:
    """``jax.checkpoint``: ``fn`` whose intermediates are recomputed in the
    backward instead of kept. Non-reentrant, so ``torch.autograd.grad``
    (:func:`value_and_grad`) runs through it; no RNG state is kept, as no
    op of a step draws random numbers; a recompute in the backward runs in
    the ``shardmap`` regions its forward ran in. ``save_dots`` keeps the
    matmuls' outputs and recomputes the rest (``checkpoint_policies.
    checkpoint_dots``)."""
    import functools

    from torch.utils.checkpoint import (checkpoint as ckpt,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if save_dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        from repro_torch import shardmap

        regions = shardmap.regions()

        def body(*a):             # a recompute runs in the forward's regions
            with shardmap.regions_as(regions):
                return fn(*a)

        return ckpt(body, *args, use_reentrant=False,
                    preserve_rng_state=False, **kw)

    return run


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm}


def shard_axis(n: int, tp: int) -> Optional[str]:
    """'model' if n shards evenly over the TP axis, else replicate (None)."""
    return "model" if tp > 0 and n % tp == 0 and n >= tp else None


def param_count(schema) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(schema, is_pspec))


# ---------------------------------------------------------------------------
# Apply-time context
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    """Threaded through every block's ``apply``. ``mesh`` is the
    ``torch.distributed`` device mesh of ``mesh_cfg`` (``launch/mesh.py``)
    or None (one device)."""

    cfg: ModelConfig
    mesh_cfg: MeshConfig
    mode: str                          # "train" | "prefill" | "decode"
    mesh: Optional[Any] = None
    par: ParallelismConfig = ParallelismConfig()
    positions: Optional[torch.Tensor] = None   # (B, S) absolute positions
    attn_impl: str = "ref"                     # "ref" | "flash" (kernel B5)
    # the parameters are this rank's blocks over "model" of every leaf the
    # step computes split (``lm._model_specs``), in a region manual over
    # "model": each layer computes its share and sums it with ``psum``
    split: bool = False

    @property
    def dp(self) -> Tuple[str, ...]:
        if self.par.grad_compression:
            return ()   # inside the manual-DP region: batch dims are local
        return self.mesh_cfg.dp_axes

    @property
    def tp_size(self) -> int:
        return self.mesh_cfg.axis_size("model")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.par.compute_dtype)

    def splits(self, n: int) -> bool:
        """Whether a dim of whole size ``n`` (heads, ``d_ff``, vocabulary)
        is this rank's block over ``"model"`` here: the step computes
        split (:attr:`split`) and the dim's layout names ``"model"``
        (:func:`shard_axis`, as the schemas lay it)."""
        return self.split and shard_axis(n, self.tp_size) == "model"

    def constrain(self, x: torch.Tensor, spec=None) -> torch.Tensor:
        """The reference pins an activation's layout here (batch over the
        data axes, the rest replicated by default). Nothing moves here:
        each rank holds an activation whole over the axes it computes
        replicated, and its block over ``"model"`` where the step computes
        split (``head_logits``' vocabulary, whose size it checks). This
        returns ``x`` after checking that in a region manual over the
        layout's batch axes the batch dim is the local batch of the
        operands the region cut. Outside one a batch need not divide the
        axes: the reference's XLA pads such a layout (a server on a mesh
        prefills one request at a time)."""
        if self.mesh is None or self.mesh.size() == 1:
            return x
        from repro_torch import shardmap

        r = shardmap.current_region()
        axes = axes_of(pspec(self.dp if spec is None else (
            spec[0] if spec else None))[0])
        manual = tuple(a for a in axes if r is not None and a in r.manual)
        if manual:
            local = dict(r.batch).get(manual)
            if local is not None and x.shape[0] != local:
                raise ValueError(
                    f"activation batch {x.shape[0]} is not the local batch "
                    f"{local} of the layout over {manual}")
        return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_schema(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": PSpec((d,), init="ones"),
                "bias": PSpec((d,), init="zeros")}
    return {"scale": PSpec((d,), init="ones")}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3 qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (B, S) -> cos/sin (B, S, head_dim/2), f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd). Rotates pairs (even, odd) halves (llama convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU-2mat / relu^2)
# ---------------------------------------------------------------------------


def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None, tp: int = 16):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    fa = shard_axis(f, tp)
    if cfg.act in ("gelu", "relu_sq"):
        return {"wi": PSpec((d, f), (None, fa)),
                "wo": PSpec((f, d), (fa, None))}
    return {"w_gate": PSpec((d, f), (None, fa)),
            "w_up": PSpec((d, f), (None, fa)),
            "wo": PSpec((f, d), (fa, None))}


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``"model"`` (``shardmap.psum``): the partial
    products of a matmul whose contracted dim is split over it."""
    from repro_torch import shardmap

    return shardmap.psum(x, "model")


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP on a replicated ``x``. ``d_ff``: its whole hidden width
    (default ``cfg.d_ff``); where it splits over ``"model"``
    (:meth:`Ctx.splits`), ``wi``/``w_gate``/``w_up`` are the rank's
    columns and ``wo`` its rows, and the output is summed over the axis."""
    dt = ctx.compute_dtype
    xd = x.to(dt)
    if "w_gate" in p:
        g = xd @ p["w_gate"].to(dt)
        u = xd @ p["w_up"].to(dt)
        h = F.silu(g) * u
    else:
        h = xd @ p["wi"].to(dt)
        if cfg.act == "gelu":
            h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
        else:  # relu^2 (RWKV channel-mix nonlinearity)
            h = F.relu(h).square()
    y = h @ p["wo"].to(dt)
    if ctx.splits(d_ff or cfg.d_ff):
        y = model_sum(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_schema(cfg: ModelConfig, tp: int = 16):
    v = cfg.padded_vocab
    va = None if cfg.embed_replicated else shard_axis(v, tp)
    sch: Any = {"embedding": PSpec((v, cfg.d_model), (va, None),
                                   init="embed")}
    if not cfg.tie_embeddings:
        sch["lm_head"] = PSpec((cfg.d_model, v), (None, shard_axis(v, tp)))
    return sch


def _vocab_rows_split(cfg: ModelConfig, ctx: Ctx) -> bool:
    return ctx.splits(cfg.padded_vocab) and not cfg.embed_replicated


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: Ctx) -> torch.Tensor:
    """The tokens' rows of the embedding. Where its vocabulary is split
    over ``"model"``, each rank looks up the rows it holds, zeros the
    others and the ranks' rows are summed (the gradient scatter-adds into
    the rank's block)."""
    e = p["embedding"]
    if not _vocab_rows_split(cfg, ctx):
        return e[tokens].to(ctx.compute_dtype)
    from repro_torch import shardmap

    n = e.shape[0]
    local = tokens - shardmap.axis_index("model") * n
    held = (local >= 0) & (local < n)
    rows = e[local.clamp(0, n - 1)].to(ctx.compute_dtype)
    return model_sum(torch.where(held[..., None], rows, 0.0))


def head_split(cfg: ModelConfig, ctx: Ctx) -> bool:
    """Whether :func:`lm_logits` gives the rank's block of the vocabulary
    (the head's columns, or a tied embedding's rows, split over
    ``"model"``) rather than all of it."""
    if cfg.tie_embeddings:
        return _vocab_rows_split(cfg, ctx)
    return ctx.splits(cfg.padded_vocab)


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32: the vocabulary columns the head holds
    (this rank's where :func:`head_split`)."""
    dt = ctx.compute_dtype
    if cfg.tie_embeddings:
        w = p["embedding"].to(dt).T
    else:
        w = p["lm_head"].to(dt)
    return (h.to(dt) @ w).float()
