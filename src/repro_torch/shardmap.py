"""``shard_map`` and the axis-named collectives over a ``torch.distributed``
device mesh (port of ``repro/shardmap.py``, there a shim over the JAX
versions' ``shard_map``).

Every rank runs the same program (SPMD). :func:`shard_map` runs ``f`` in a
*region* that is manual over some of the mesh's axes: inside, ``f`` sees
each operand's block for its ``in_spec``, and the collectives below name
the region's axes. Outside any region a tensor is the global value, held
whole by every rank (or a ``DTensor``); inside one, a tensor is this
rank's block over the manual axes. Regions nest: an axis already manual
in an enclosing region is not cut again, and an operand's spec entry for
it only says that the block is already local.

Operands, per leaf of the argument trees (``in_specs`` is a prefix tree of
:class:`P`, as JAX's):

* a tensor is cut along each newly manual axis its spec names (a dim split
  over several axes: the first one major), by this rank's mesh coordinate;
* a ``DTensor`` on the region's mesh (or on a sub-mesh of newly manual
  axes) is redistributed to the spec's placements and then ``to_local()``;
* outputs are put back together by ``out_specs``: gathered over the newly
  manual axes their spec names, taken as they are over the others (a
  value the spec leaves replicated must be the same on those ranks).

Autograd follows JAX's transposition of a region (``shard_map`` with
``check_vma=False``, which for every program whose replicated outputs are
replicated gives the same gradients as ``check_vma=True``):

* an operand that enters replicated over a newly manual axis (its spec does
  not name it) has its cotangent summed over that axis on the way out; an
  operand cut along an axis gets its gradient gathered back;
* an output left replicated over a newly manual axis hands each of those
  ranks ``1/n`` of its cotangent;
* ``psum``'s backward is a ``psum``; with the output's ``1/n`` before it,
  a sum whose result leaves the region replicated passes its cotangent
  through unchanged, the identity of JAX's ``check_vma`` rule;
* ``all_gather``'s backward is the matching reduce-scatter,
  ``all_to_all``'s the inverse ``all_to_all``, ``ppermute``'s the inverse
  permutation; ``pvary`` is the identity both ways.

So ``grad(sum(psum(x * (1 + axis_index("model")), "model")))`` over a
``P()`` operand is ``3`` everywhere on a model axis of 2, as in JAX, where
``torch.distributed.nn``'s ``all_reduce`` (its backward an all-reduce, no
rule at the region's edges) gives ``2``.

Axis sizes of 1 move no data. A region over a mesh of more than one rank
needs an initialised process group (the ``DeviceMesh`` does); nothing
here creates one. Every collective adds its ring-model wire bytes (those
of ``energy/roofline.py``'s reading of XLA's collectives) to
:data:`wire_bytes`.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Optional, Sequence, Tuple

import torch

from repro_torch.model.layers import axes_of, placements, pspec

#: the reference module's flag, True on its jax: a ``ppermute`` inside a
#: region manual over only some axes works, as every ``ppermute`` here
#: does (``optim/compress.py`` takes the butterfly without asking)
PARTIAL_AUTO_PPERMUTE_OK = True

#: ring-model bytes this rank sent, by collective kind (see module doc)
wire_bytes: Dict[str, float] = {}


def reset_wire_bytes() -> None:
    wire_bytes.clear()


def _count(kind: str, nbytes: float) -> None:
    wire_bytes[kind] = wire_bytes.get(kind, 0.0) + float(nbytes)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry per leading dim, each None, an axis name or a tuple of names
    (normalised as ``tuple(PartitionSpec(...))``: ``()`` is None, a
    one-name tuple the name). A leaf of a spec tree; plain tuples are
    containers."""

    def __new__(cls, *entries):
        return super().__new__(cls, pspec(*entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _names(axis) -> Tuple[str, ...]:
    """An axis argument (a name or a tuple of names) as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Region:
    """A manual region: its mesh and every axis manual in it (this
    region's and the enclosing ones'). ``batch``: (axes, size) of the
    first dim of the operands a region cut along it, by the axes that cut
    it (``Ctx.constrain`` checks activations against it)."""

    mesh: Any
    manual: FrozenSet[str]
    batch: Tuple[Tuple[Tuple[str, ...], int], ...] = ()


_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "regions"):
        _state.regions = []
    return _state.regions


def current_region() -> Optional[Region]:
    st = _stack()
    return st[-1] if st else None


def regions() -> Tuple[Region, ...]:
    """The regions this thread is in, outermost first."""
    return tuple(_stack())


@contextlib.contextmanager
def regions_as(saved: Tuple[Region, ...]):
    """Run the body in ``saved`` (:func:`regions`) in place of this
    thread's regions: a recompute in the backward runs in its forward's
    (``layers.checkpoint``)."""
    st = _stack()
    outer = st[:]
    st[:] = saved
    try:
        yield
    finally:
        st[:] = outer


class region:
    """Context manager: run the body manual over ``axes`` of ``mesh``
    (every axis by default), with no operand cut and no edge rule: for
    code that is not differentiated and holds its blocks already (the
    optimizer's update on each rank's slices, ``optim/adamw.py``)."""

    def __init__(self, mesh, axes: Optional[Sequence[str]] = None,
                 batch: Tuple[Tuple[Tuple[str, ...], int], ...] = ()):
        outer = current_region()
        names = tuple(mesh.mesh_dim_names)
        axes = names if axes is None else tuple(axes)
        _check_mesh(mesh)
        self.r = Region(mesh, frozenset(axes) | (outer.manual if outer
                                                 else frozenset()),
                        (outer.batch if outer else ()) + tuple(batch))

    def __enter__(self):
        _stack().append(self.r)
        return self.r

    def __exit__(self, *exc):
        _stack().pop()
        return False


def _check_mesh(mesh) -> None:
    import torch.distributed as dist

    if mesh.size() > 1 and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a region over the mesh {tuple(mesh.mesh.shape)} needs an "
            "initialised process group (torch.distributed."
            "init_process_group with its address, world size and rank)")


def _region_for(axes: Tuple[str, ...]) -> Region:
    r = current_region()
    if r is None:
        raise NameError(f"unbound axis name {axes}: collectives run inside "
                        "a shard_map region")
    for a in axes:
        if a not in r.manual:
            raise NameError(f"unbound axis name {a!r}: not manual in this "
                            f"region (manual: {sorted(r.manual)})")
    return r


def _size(mesh, name: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(name))


def _index(mesh, name: str) -> int:
    return mesh.get_local_rank(name)


def axis_size(axis) -> int:
    """The product of the sizes of ``axis`` (a name or a tuple)."""
    axes = _names(axis)
    r = _region_for(axes)
    return math.prod(_size(r.mesh, a) for a in axes)


def axis_index(axis) -> int:
    """This rank's index along ``axis``; over a tuple, the first axis
    major."""
    axes = _names(axis)
    r = _region_for(axes)
    idx = 0
    for a in axes:
        idx = idx * _size(r.mesh, a) + _index(r.mesh, a)
    return idx


def pvary(x, axis_names):                               # noqa: ARG001
    """The identity both ways: JAX's annotation of varying-ness, which
    this transposition does not need."""
    return x


# ---------------------------------------------------------------------------
# Group plumbing (captured at forward time; backward may run on another
# thread, where no region is current)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Axis:
    name: str
    size: int
    index: int
    group: Any
    ranks: Tuple[int, ...]          # global rank at each index along it


def _axis(mesh, name: str) -> _Axis:
    n = _size(mesh, name)
    if n == 1:
        return _Axis(name, 1, 0, None, ())
    dim = list(mesh.mesh_dim_names).index(name)
    coord = list(mesh.get_coordinate())
    ranks = []
    for i in range(n):
        coord[dim] = i
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return _Axis(name, n, _index(mesh, name), mesh.get_group(name),
                 tuple(ranks))


def _axes(mesh, names: Sequence[str]) -> Tuple[_Axis, ...]:
    return tuple(_axis(mesh, a) for a in names)


def _all_reduce(x: torch.Tensor, axes: Sequence[_Axis]) -> torch.Tensor:
    import torch.distributed as dist

    out = x
    for ax in axes:
        if ax.size == 1:
            continue
        if out is x:
            out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=ax.group)
        _count("all-reduce", 2 * out.numel() * out.element_size()
               * (ax.size - 1) / ax.size)
    return out


def _gather(x: torch.Tensor, ax: _Axis, dim: int,
            tiled: bool) -> torch.Tensor:
    import torch.distributed as dist

    if ax.size == 1:
        return x if tiled else x.unsqueeze(dim)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    _count("all-gather", x.numel() * x.element_size() * (ax.size - 1))
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _reduce_scatter(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    """The sum over ``ax`` of ``x``, of which this rank keeps its block
    along ``dim``."""
    import torch.distributed as dist

    if ax.size == 1:
        return x
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"evenly over {ax.size} ranks")
    full = x.detach().movedim(dim, 0).contiguous()
    out = full.new_empty((full.shape[0] // ax.size,) + full.shape[1:])
    dist.reduce_scatter_tensor(out, full, group=ax.group)
    _count("reduce-scatter", full.numel() * full.element_size()
           * (ax.size - 1) / ax.size)
    return out.movedim(0, dim).contiguous()


def _block(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"evenly over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


# ---------------------------------------------------------------------------
# Collectives (autograd: see the module doc)
# ---------------------------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes), None


def psum(x, axis):
    """Sum over ``axis`` (a name or a tuple; ``()`` is the identity)."""
    axes = _names(axis)
    if not axes:
        return x
    r = _region_for(axes)
    group = _axes(r.mesh, axes)
    if all(a.size == 1 for a in group):
        return x
    return _PSum.apply(x, group)


def pmean(x, axis):
    """``psum(x, axis) / axis_size(axis)`` (a true division)."""
    axes = _names(axis)
    if not axes:
        return x
    s = psum(x, axes)
    n = axis_size(axes)
    if not s.is_floating_point():
        s = s.to(torch.float32)
    return s / torch.full_like(s, float(n))


class _LogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        # torch.logsumexp's steps, with the max and the sum over the ranks
        m = torch.amax(x, -1, keepdim=True)
        m = _gather(m, ax, -1, tiled=True).amax(-1, keepdim=True)
        m.masked_fill_(m.abs() == math.inf, 0)
        s = _all_reduce(torch.sum(torch.exp(x - m), -1), (ax,))
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, lse)
        ctx.ax = ax
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        g = _all_reduce(g, (ctx.ax,))
        return g[..., None] * torch.exp(x - lse[..., None]), None


def logsumexp(x, axis: str):
    """``logsumexp`` over the last dim of ``x``, split over ``axis`` (one
    name): the ranks' row maxima gathered (no ``pmax``, and no gradient
    through the max), their sums of exponentials summed. Its backward
    sums the cotangent over ``axis`` first, JAX's transposition of the
    ``psum`` inside. On an axis of one rank it is ``torch.logsumexp``.
    """
    r = _region_for((axis,))
    ax = _axis(r.mesh, axis)
    if ax.size == 1:
        return torch.logsumexp(x, dim=-1)
    return _LogSumExp.apply(x, ax)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """``jax.lax.all_gather``: stack (or with ``tiled`` concatenate) every
    rank's ``x`` along dim ``axis``; over a tuple of axis names the first
    one major."""
    dim = axis
    axes = _names(axis_name)
    r = _region_for(axes)
    out = x if tiled else x.unsqueeze(dim)
    for ax in reversed(_axes(r.mesh, axes)):            # innermost first
        if ax.size > 1:
            out = _AllGather.apply(out, ax, dim)
    return out


def _a2a(x: torch.Tensor, ax: _Axis, split: int, concat: int,
         tiled: bool) -> torch.Tensor:
    import torch.distributed as dist

    chunks = (list(torch.chunk(x, ax.size, split)) if tiled
              else list(x.unbind(split)))
    if len(chunks) != ax.size or (tiled and x.shape[split] % ax.size):
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} does "
                         f"not split over {ax.size} ranks")
    if ax.size == 1:
        recv = [c.clone() for c in chunks]
    else:
        chunks = [c.contiguous() for c in chunks]
        recv = [torch.empty_like(c) for c in chunks]
        dist.all_to_all(recv, chunks, group=ax.group)
        _count("all-to-all", x.numel() * x.element_size()
               * (ax.size - 1) / ax.size)
    return torch.cat(recv, concat) if tiled else torch.stack(recv, concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split, concat, tiled):
        ctx.args = (ax, split, concat, tiled)
        return _a2a(x, ax, split, concat, tiled)

    @staticmethod
    def backward(ctx, g):
        ax, split, concat, tiled = ctx.args
        return _a2a(g, ax, concat, split, tiled), None, None, None, None


def all_to_all(x, axis, split_axis: int, concat_axis: int, *,
               tiled: bool = False):
    """``jax.lax.all_to_all``: chunk ``split_axis`` over the ranks of
    ``axis``, send chunk ``j`` to rank ``j``, and put the received chunks
    along ``concat_axis`` (stacked without ``tiled``: ``split_axis`` must
    have the axis size and is taken out)."""
    axes = _names(axis)
    if len(axes) != 1:
        raise NotImplementedError("all_to_all over one axis")
    r = _region_for(axes)
    return _AllToAll.apply(x, _axis(r.mesh, axes[0]), split_axis,
                           concat_axis, tiled)


def _permute(x: torch.Tensor, ax: _Axis, perm) -> torch.Tensor:
    import torch.distributed as dist

    dst = [d for s, d in perm if s == ax.index]
    src = [s for s, d in perm if d == ax.index]
    out = torch.zeros_like(x)
    if ax.size == 1:
        return x.clone() if dst and src else out
    ops = []
    xc = x.detach().contiguous()
    for d in dst:
        ops.append(dist.P2POp(dist.isend, xc, ax.ranks[d], ax.group))
        _count("collective-permute", xc.numel() * xc.element_size())
    for s in src:
        ops.append(dist.P2POp(dist.irecv, out, ax.ranks[s], ax.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.ax, inv), None, None


def ppermute(x, axis, perm):
    """``jax.lax.ppermute``: send ``x`` from index ``s`` to ``d`` for each
    ``(s, d)`` of ``perm`` along ``axis``; a rank nobody sends to gets
    zeros."""
    axes = _names(axis)
    if len(axes) != 1:
        raise NotImplementedError("ppermute over one axis")
    r = _region_for(axes)
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, _axis(r.mesh, axes[0]), perm)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _is_spec(s) -> bool:
    return s is None or isinstance(s, P)


def _map_prefix(fn, specs, tree):
    """Apply ``fn(spec, leaf)`` to every leaf of ``tree``, with ``specs``
    a prefix tree of it (a :class:`P` covers a whole subtree)."""
    if _is_spec(specs):
        spec = specs if specs is not None else P()
        return _map_leaves(lambda t: fn(spec, t), tree)
    if isinstance(specs, dict):
        return {k: _map_prefix(fn, specs[k], tree[k]) for k in tree}
    if isinstance(specs, (tuple, list)):
        if len(specs) != len(tree):
            raise ValueError(f"spec tree of {len(specs)} entries for a tree "
                             f"of {len(tree)}")
        return type(tree)(_map_prefix(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"not a spec tree: {specs!r}")


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    if torch.is_tensor(tree):
        return fn(tree)
    return tree


def _cuts(spec: P, new: FrozenSet[str], names) -> list:
    """[(dim, axis names in ``new`` that split it, first major)]."""
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in axes_of(entry) if a in new]
        for a in axes_of(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {tuple(names)}")
        if axes:
            out.append((dim, tuple(axes)))
    return out


class _Enter(torch.autograd.Function):
    """Cut a global tensor to this rank's block; backward: sum over the
    axes it is replicated over, gather over the ones it is cut along."""

    @staticmethod
    def forward(ctx, x, cuts, rep):
        ctx.cuts, ctx.rep = cuts, rep
        out = x
        for dim, axes in cuts:
            for ax in axes:                      # first axis major
                out = _block(out, dim, ax.index, ax.size)
        return out if out is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.rep)
        for dim, axes in reversed(ctx.cuts):
            for ax in reversed(axes):
                g = _gather(g, ax, dim, tiled=True)
        return g, None, None


class _Exit(torch.autograd.Function):
    """Put a block back together; backward: this rank's block of the
    cotangent, over the product of the axes left replicated."""

    @staticmethod
    def forward(ctx, x, cuts, n_rep):
        ctx.cuts, ctx.n_rep = cuts, n_rep
        out = x
        for dim, axes in reversed(cuts):
            for ax in reversed(axes):            # innermost first
                out = _gather(out, ax, dim, tiled=True)
        return out if out is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for dim, axes in ctx.cuts:
            for ax in axes:
                g = _block(g, dim, ax.index, ax.size)
        if ctx.n_rep != 1:
            g = g / torch.full_like(g, float(ctx.n_rep))
        return g.contiguous(), None, None


def _enter(spec: P, x, mesh, new: FrozenSet[str]):
    names = tuple(mesh.mesh_dim_names)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _enter_dtensor(spec, x, new)
    cuts = _cuts(spec, new, names)
    named = {a for _, axes in cuts for a in axes}
    rep = _axes(mesh, [a for a in names if a in new and a not in named])
    cut_axes = [(d, _axes(mesh, axes)) for d, axes in cuts]
    if not cut_axes and all(a.size == 1 for a in rep):
        return x
    return _Enter.apply(x, cut_axes, rep)


def _enter_dtensor(spec: P, x, new: FrozenSet[str]):
    from torch.distributed.tensor import Partial

    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names or ())
    if not names or not set(names) <= new:
        raise ValueError(f"a DTensor on mesh axes {names} enters a region "
                         f"manual over {sorted(new)} (its axes must all be "
                         "newly manual)")
    target = placements(dm, spec)
    x = x.redistribute(dm, target)
    # the cotangent of a replicated operand is summed on the way out
    return x.to_local(grad_placements=[
        p if p.is_shard() else Partial() for p in target])


def _exit(spec: P, x, mesh, new: FrozenSet[str]):
    names = tuple(mesh.mesh_dim_names)
    cuts = _cuts(spec, new, names)
    named = {a for _, axes in cuts for a in axes}
    n_rep = math.prod(_size(mesh, a) for a in names
                      if a in new and a not in named)
    cut_axes = [(d, _axes(mesh, axes)) for d, axes in cuts]
    if not cut_axes and n_rep == 1:
        return x
    return _Exit.apply(x, cut_axes, n_rep)


def shard_map(f: Callable, *, mesh, in_specs, out_specs, axis_names=None,
              check_vma=None):                            # noqa: ARG001
    """``f`` over each rank's blocks of its operands (see the module
    doc). ``axis_names``: the axes to make manual (every mesh axis by
    default); ``check_vma`` is accepted and not read (no replication
    checker; the transposition is the same)."""
    names = tuple(mesh.mesh_dim_names)
    axes = names if axis_names is None else tuple(
        a for a in names if a in set(axis_names))
    for a in (axis_names or ()):
        if a not in names:
            raise ValueError(f"axis {a!r} is not an axis of the mesh {names}")

    def wrapped(*args):
        outer = current_region()
        if outer is not None and outer.mesh is not mesh and tuple(
                outer.mesh.mesh_dim_names) != names:
            raise ValueError("a nested region must be over the same mesh")
        done = outer.manual if outer is not None else frozenset()
        new = frozenset(axes) - done
        if not _is_spec(in_specs) and len(in_specs) != len(args):
            raise ValueError(f"{len(in_specs)} in_specs for {len(args)} "
                             "arguments")
        batch = {}

        def enter(spec, t):
            block = _enter(spec, t, mesh, new)
            axes0 = axes_of(spec[0]) if len(spec) and t.ndim else ()
            if set(axes0) & new:
                batch.setdefault(axes0, block.shape[0])
            return block

        local = _map_prefix(enter, in_specs if _is_spec(in_specs)
                            else tuple(in_specs), tuple(args))
        with region(mesh, tuple(done | new), tuple(batch.items())):
            out = f(*local)
        return _map_prefix(lambda s, t: _exit(s, t, mesh, new), out_specs,
                           out)

    return wrapped
