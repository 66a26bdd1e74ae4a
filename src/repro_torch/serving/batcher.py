"""Dynamic micro-batcher: pack ragged windows, dispatch once, de-chunk
(port of ``repro/serving/batcher.py``).

The RTL designs are fixed-window accelerators — every template bakes its
``seq_len`` into the node (DESIGN.md §9), so a deployment only ever accepts
``(B, L, F)`` batches at its own window length ``L``. Heterogeneous traffic
(windows of varied length ``T``) therefore buckets by length: each design
family registers the window lengths its deployed variants were lowered at,
a ``T``-sample request routes to the smallest bucket with ``L >= T``, and
the window is zero-padded from ``T`` to ``L``.

Within a bucket the batcher packs: stack all padded windows along the batch
axis, optionally pad the batch dimension up to the next power of two
(``pad_batch=True``) so the emulator's compiled-program LRU sees a bounded
set of ``(B, L, F)`` shapes and mixed traffic never builds a new program
(on CUDA, never captures a new CUDA Graph), then dispatch
the whole block through one ``run_many``-style call and slice each
request's rows back out (:func:`unpack`).

Bit-exactness contract: batch rows are independent in every template (the
``run_many`` property), so the de-chunked result of a
packed dispatch is integer-identical to calling the deployment on each
padded window alone. The batcher never changes *what* is computed for a
request — only how many requests share one program dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.queue import ServeRequest


def bucket_for(lengths: Sequence[int], t: int) -> int:
    """The smallest registered window length that fits a ``t``-sample
    window. Raises with the registered lengths when nothing fits."""
    if t < 1:
        raise ValueError(f"window length must be >= 1, got {t}")
    fits = [ln for ln in lengths if ln >= t]
    if not fits:
        raise ValueError(
            f"no window bucket fits length {t}; registered lengths: "
            f"{sorted(lengths)}")
    return min(fits)


def pad_window(x: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad a ``(T, F)`` window to ``(length, F)`` along time."""
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"window must be (T, F), got shape {x.shape}")
    t = x.shape[0]
    if t > length:
        raise ValueError(f"window length {t} exceeds bucket length {length}")
    if t == length:
        return x
    pad = np.zeros((length - t, x.shape[1]), x.dtype)
    return np.concatenate([x, pad], axis=0)


def padded_batch_size(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at ``max_batch`` (programs compile
    per total batch size, so quantizing B bounds the program-cache set).

    ``max_batch`` is a hard cap: exactly ``max_batch`` real rows must not
    round up past it (B=64 at cap 64 stays 64), and more rows than the
    cap is a caller error — :func:`pack` splits oversized groups into
    multiple batches *before* sizing each one.
    """
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if n > max_batch:
        raise ValueError(
            f"batch of {n} rows exceeds max_batch={max_batch}; split the "
            "group into multiple dispatches first (pack does)")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


@dataclass
class MicroBatch:
    """One packed dispatch: ``array`` is ``(B_padded, L, F)`` with the
    first ``len(requests)`` rows real and the rest zero filler."""

    design: str
    bucket_len: int
    requests: List[ServeRequest]
    array: np.ndarray

    @property
    def fill(self) -> float:
        """Real rows / dispatched rows — the padding overhead observable."""
        return len(self.requests) / self.array.shape[0]


def pack(design: str, bucket_len: int, requests: List[ServeRequest], *,
         pad_batch: bool = True, max_batch: int = 64) -> List[MicroBatch]:
    """Pad each request's window to ``bucket_len``, stack along batch, and
    (optionally) pad the batch dimension to a power of two.

    Returns a *list* of batches: a group larger than ``max_batch`` splits
    into ``ceil(n / max_batch)`` dispatches (each at most ``max_batch``
    rows) instead of raising or silently dispatching an over-cap shape
    the program cache was never sized for.
    """
    if not requests:
        raise ValueError("cannot pack an empty batch")
    batches: List[MicroBatch] = []
    for i in range(0, len(requests), max_batch):
        chunk = list(requests[i:i + max_batch])
        rows = [pad_window(np.asarray(r.window, np.float32), bucket_len)
                for r in chunk]
        arr = np.stack(rows, axis=0)
        if pad_batch:
            b = padded_batch_size(len(rows), max_batch)
            if b > len(rows):
                filler = np.zeros((b - len(rows),) + arr.shape[1:],
                                  arr.dtype)
                arr = np.concatenate([arr, filler], axis=0)
        batches.append(MicroBatch(design=design, bucket_len=bucket_len,
                                  requests=chunk, array=arr))
    return batches


def unpack(batch: MicroBatch, outputs) -> None:
    """De-chunk one dispatch: slice row ``i`` of ``outputs`` back onto
    request ``i``. Filler rows are dropped, and rows whose request is
    already terminal (e.g. expired at dispatch time) keep their verdict —
    a missed deadline must not grow a result. Marks nothing terminal
    itself — the farm owns status transitions (it also stamps
    timing/provenance)."""
    out = np.asarray(outputs)
    if out.shape[0] < len(batch.requests):
        raise ValueError(
            f"dispatch returned {out.shape[0]} rows for "
            f"{len(batch.requests)} requests")
    for i, req in enumerate(batch.requests):
        if req.terminal:
            continue
        req.result = out[i]


@dataclass
class MicroBatcher:
    """Groups admitted requests into :class:`MicroBatch` dispatches.

    ``buckets`` maps a design family to the window lengths its deployed
    variants accept (sorted ascending). :meth:`form` greedily fills
    per-``(design, bucket)`` groups: full batches (``max_batch``) always
    flush; partial batches flush when forced (``flush=True``) or when their
    oldest request has lingered past ``max_wait_s`` — the classic dynamic
    batcher latency/throughput dial.
    """

    buckets: Dict[str, Tuple[int, ...]]
    max_batch: int = 64
    max_wait_s: float = 0.002
    pad_batch: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.buckets = {d: tuple(sorted(ls))
                        for d, ls in self.buckets.items()}
        for d, ls in self.buckets.items():
            if not ls:
                raise ValueError(f"design {d!r} registers no window lengths")

    def bucket(self, design: str, t: int) -> int:
        if design not in self.buckets:
            raise KeyError(f"unknown design {design!r}; registered: "
                           f"{sorted(self.buckets)}")
        return bucket_for(self.buckets[design], t)

    def form(self, requests: List[ServeRequest], *, now: float,
             flush: bool = False
             ) -> Tuple[List[MicroBatch], List[ServeRequest]]:
        """Partition ``requests`` into ready dispatches and leftovers.

        Returns ``(batches, lingering)``: lingering requests go back to the
        queue (FIFO order preserved) to accumulate a fuller batch.
        """
        groups: Dict[Tuple[str, int], List[ServeRequest]] = {}
        for req in requests:
            key = (req.design, self.bucket(req.design,
                                           int(np.asarray(req.window).shape[0])))
            req.bucket_len = key[1]
            groups.setdefault(key, []).append(req)
        batches: List[MicroBatch] = []
        lingering: List[ServeRequest] = []
        for (design, ln), group in groups.items():
            n_full = (len(group) // self.max_batch) * self.max_batch
            if n_full:                   # full batches always flush
                batches.extend(pack(design, ln, group[:n_full],
                                    pad_batch=self.pad_batch,
                                    max_batch=self.max_batch))
                group = group[n_full:]
            if group:
                waited = now - min(r.t_submit for r in group)
                if flush or waited >= self.max_wait_s:
                    batches.extend(pack(design, ln, group,
                                        pad_batch=self.pad_batch,
                                        max_batch=self.max_batch))
                else:
                    lingering.extend(group)
        # keep queue order stable for the requeue
        lingering.sort(key=lambda r: r.rid)
        return batches, lingering
