"""Atomic, async checkpointing with restore onto any device (port of
``repro/checkpoint/ckpt.py``, the same files).

Layout:  <dir>/step_<n>/
             manifest.json       (tree structure + shapes + dtypes + step)
             arrays.npz          (flat path-keyed tensors, copied to the host)
         <dir>/LATEST            (atomic pointer file)

* **atomic**: written into ``step_n.tmp-<pid>``, fsynced, renamed; the
  LATEST pointer is written last, so a crash mid-save never corrupts a
  checkpoint.
* **async**: ``CheckpointManager.save_async`` copies the tree to host
  memory before it returns and writes in a background thread, so the
  train loop waits only for the device-to-host copy and may update its
  tensors in place right after.
* **elastic**: a restore places each leaf on the device of the matching
  leaf of ``like``, so a checkpoint written on the CPU restores onto the
  card and back; given ``shardings`` (``layers.shardings`` on a device
  mesh), each rank gets its block of each leaf, so a checkpoint written
  on one mesh restores onto any other. A multi-rank run writes one set
  of whole arrays (:func:`gather_tree` brings them to rank 0, which
  saves them), the files a one-device run writes.
* **bounded**: keeps the last ``keep`` checkpoints and deletes older ones.

Keys are ``/``-joined paths in the reference's flatten order (dict keys
sorted, sequence indices), so each package reads the other's float32 and
int32 checkpoints. A bfloat16 leaf is stored as the reference stores one
(numpy has no bfloat16: 2-byte ``V2`` records, manifest dtype
``"bfloat16"``) and restored by reinterpreting the bits, which the
reference's ``astype`` cannot do.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.model.layers import tree_map


def _items(tree, prefix=()):
    """(path, leaf) of every tensor of a nested dict/list/tuple tree, in
    the reference's flatten order (``tree_map``'s); ``None`` holds no
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints
    it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            if isinstance(t, list):
                return f"[{inner}]"
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"

    return f"PyTreeDef({walk(tree)})"


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf (never a view of the caller's memory) and
    its manifest dtype."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _snapshot(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, dict], str]:
    flat, keys = {}, {}
    for key, leaf in _items(tree):
        arr, dtype = _to_host(leaf)
        flat[key] = arr
        keys[key] = {"shape": list(arr.shape), "dtype": dtype}
    return flat, keys, _treedef(tree)


def save_checkpoint(path: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final directory."""
    return _write(path, step, *_snapshot(tree), keep=keep)


def _write(path: str, step: int, flat: Dict[str, np.ndarray],
           keys: Dict[str, dict], treedef: str, *, keep: int) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "treedef": treedef, "keys": keys}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(path, "LATEST.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(path, "LATEST.tmp"), os.path.join(path, "LATEST"))
    _gc(path, keep)
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
        and "." not in d.split("_")[1])
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        s = int(f.read().strip())
    if not os.path.isdir(os.path.join(path, f"step_{s:08d}")):
        return None
    return s


def load_checkpoint(path: str, step: int, like: Any,
                    shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf a tensor of the ``like`` leaf's dtype on its device. With
    ``shardings`` (a tree of ``layers.Sharding`` of ``like``'s structure;
    a None subtree restores whole), each leaf is this rank's block of the
    saved array, and its ``like`` leaf may be whole or that block. A shape
    that differs raises ``ValueError``."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["keys"].items()}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    shard_of = dict(_sharding_items(like, shardings))
    restored = []
    for key, leaf in _items(like):
        arr = flat[key]
        sh = shard_of.get(key)
        want = tuple(arr.shape)
        if sh is not None:
            shape, off = sh.local_shape_and_offset(arr.shape)
            if tuple(leaf.shape) not in (want, tuple(shape)):
                raise ValueError(f"{key}: checkpoint {arr.shape} (block "
                                 f"{tuple(shape)}) != {tuple(leaf.shape)}")
            arr = arr[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        elif tuple(leaf.shape) != want:
            raise ValueError(f"{key}: checkpoint {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        arr = np.require(arr, requirements="C")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if dtypes[key] == "bfloat16" else torch.from_numpy(arr))
        restored.append(t.to(device=leaf.device, dtype=leaf.dtype))
    it = iter(restored)                  # tree_map visits _items' order
    return tree_map(lambda _: next(it), like)


def _sharding_items(like, shardings, prefix=()):
    """(key, Sharding) of every leaf of ``like`` that ``shardings`` places
    (a None subtree places none)."""
    if shardings is None:
        return
    if isinstance(like, dict):
        for k in sorted(like):
            yield from _sharding_items(like[k], shardings[k], prefix + (
                str(k),))
    elif isinstance(like, (list, tuple)):
        for i, t in enumerate(like):
            yield from _sharding_items(t, shardings[i], prefix + (str(i),))
    elif like is not None:
        yield "/".join(prefix), shardings


@torch.no_grad()
def gather_tree(tree: Any, shardings: Any, mesh: Any) -> Optional[Any]:
    """Every leaf whole on the host of the writer, the rank at ``mesh``'s
    coordinate 0, from each rank's blocks of it (``shardings``, as
    :func:`load_checkpoint`'s; a leaf split over no axis is the writer's
    own): collective, so every rank of the mesh calls it; the others get
    None. Leaf by leaf, the ranks that hold a distinct block send it to the
    writer alone, which copies each to the host as it arrives: no rank
    holds more than its own blocks and one more on its device. Splits
    must be even."""
    coord = mesh.get_coordinate()
    writer = coord is not None and not any(coord)
    shard_of = dict(_sharding_items(tree, shardings))
    out = [_gather_leaf(key, t, shard_of.get(key), writer)
           for key, t in _items(tree)]
    if not writer:
        return None
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def _gather_leaf(key: str, t: torch.Tensor, sh, writer: bool):
    import torch.distributed as dist

    splits = sh._splits(t.ndim) if sh is not None else [[]] * t.ndim
    split = {m for ms in splits for m in ms}
    if not split:
        return t if writer else None
    mesh = sh.mesh
    shape = tuple(n * math.prod(mesh.size(m) for m in ms)
                  for n, ms in zip(t.shape, splits))
    if sh.local_shape_and_offset(shape)[0] != tuple(t.shape):
        raise ValueError(f"{key}: the block {tuple(t.shape)} is not an even "
                         f"part of {shape}")
    me = dist.get_rank()
    whole = torch.empty(shape, dtype=t.dtype) if writer else None
    grid = mesh.mesh
    for coord in itertools.product(*(range(n) for n in grid.shape)):
        if any(c for m, c in enumerate(coord) if m not in split):
            continue                 # a replica of a block sent already
        src = int(grid[coord])
        if writer:
            if src == me:
                block = t
            else:
                block = torch.empty_like(
                    t, memory_format=torch.contiguous_format)
                dist.recv(block, src=src)
            size, off = sh.local_shape_and_offset(shape, coord)
            whole[tuple(slice(o, o + n) for o, n in zip(off, size))] = \
                block.cpu()
        elif src == me:
            dist.send(t.contiguous(), dst=int(grid[(0,) * grid.ndim]))
    return whole


class CheckpointManager:
    """Async, bounded checkpoint manager for the trainer."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to the host now, write it in a thread."""
        self.wait()
        snapshot = _snapshot(tree)

        def _run():
            try:
                _write(self.path, step, *snapshot, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def latest(self) -> Optional[int]:
        return latest_step(self.path)

    def restore(self, like: Any, shardings: Optional[Any] = None,
                step: Optional[int] = None) -> Tuple[int, Any]:
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        return step, load_checkpoint(self.path, step, like, shardings)
