"""Public wrapper of the decode-attention kernel: one new token's GQA
attention over the serving cache's unrepeated K/V, each row read only up
to its own length.

``model/attention.py::attn_apply`` calls it for every decode layer with
``attn_impl="flash"``. Forward only: decode builds no graph.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import reports
from repro_torch.kernels.decode_attention.kernel import (DTYPES, VARIANTS,
                                                         decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

#: kernel launches made by :func:`decode_attention` (CPU calls do not
#: count); a launch is one call: the main kernel and its combine pass
launches = 0
#: ... by variant: "mma" (bf16) and "simt" (f32)
launches_by_variant = {"mma": 0, "simt": 0}

MAX_HEAD_DIM = 256
#: q heads a kv head the kernels take: the 16 rows of the mma tile
MAX_GROUP = 16
#: keys a split holds come in tiles of this many (the mma variant's tile)
TILE = 64
#: splits aim at this many blocks an SM in all, live or not, and give each
#: split at least MIN_TILES tiles: a block's start (q, the ring's first
#: tile) and end (the partial's write and merge) cost about what a few
#: tiles do, and a block that exits at once costs a slot too. At Yi-9B's
#: serving shapes on an H100 (32 or 16 slots of 4,096, 297-4,096 keys
#: live), chunks of 128 keys took 1.6-2.0 times as long as chunks of 512,
#: and chunks of 512 to 2,048 lay within 16% of one another
BLOCKS_PER_SM = 2
MIN_TILES = 8


def split_plan(rows: int, s_max: int, n_sm: int) -> tuple:
    """(splits, chunk): each of ``rows`` (batch x kv heads) rows of
    ``s_max`` keys cut into ``splits`` splits of ``chunk`` keys, a whole
    number of tiles, from the shapes and the SM count alone (the lengths
    stay on the device)."""
    tiles = -(-s_max // TILE)
    want = -(-BLOCKS_PER_SM * n_sm // rows)
    per = min(tiles, max(MIN_TILES, -(-tiles // want)))
    return -(-tiles // per), per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, kv_len) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"decode_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"decode_attention: {name} is {t.dtype}; q, k,"
                             f" v must share one of "
                             f"{sorted(map(str, DTYPES))}")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name}'s head dim must be "
                             "contiguous")
    B, sq, H, hd = q.shape
    if (sq != 1 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != hd or k.shape[1] < 1 or H % k.shape[2]):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match"
                         " (q (B, 1, H, hd), K/V (B, S, KV, hd), KV "
                         "dividing H)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: needs 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if (kv_len.shape != (B,) or kv_len.dtype not in (torch.int32, torch.int64)
            or kv_len.device != q.device):
        raise ValueError(f"decode_attention: kv_len must be ({B},) int32 or "
                         f"int64 on {q.device}, got {tuple(kv_len.shape)} "
                         f"{kv_len.dtype} on {kv_len.device}")


def _check_kernel(q, k, v) -> None:
    """What the kernels take beyond :func:`_check`: G <= 16; in bf16 hd a
    multiple of 8 and K/V at 16-byte aligned bases and strides (the
    cp.async chunks)."""
    G, hd = q.shape[2] // k.shape[2], q.shape[3]
    if G > MAX_GROUP:
        raise ValueError(f"decode_attention: {G} q heads a kv head, the "
                         f"kernels take at most {MAX_GROUP}")
    if q.dtype == torch.bfloat16 and (hd % 8 or any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (k, v))):
        raise ValueError(f"decode_attention: bf16 needs hd % 8 == 0 and K/V"
                         f" rows 16-byte aligned, got hd {hd}, strides "
                         f"{k.stride()}, {v.stride()}")


def decode_flops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> int:
    """The two products over every cache position: 4 · hd per (row, q
    head, key) of the (B, S) the caller holds (the lengths live on the
    device, so every position counts, as the plain path computes)."""
    B, _, H, hd = q.shape
    return 4 * B * H * hd * k.shape[1]


@reports("decode_attention", decode_flops)
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd); k, v (B, S, KV, hd), the cache unrepeated; kv_len
    (B,) the valid length of each row (clamped to S). Returns (B, 1, H,
    hd) in q's dtype.

    On a CUDA tensor this launches the kernel of q's dtype ("mma" for
    bf16, "simt" for f32) and raises on a shape it does not take (G > 16;
    in bf16 hd % 8 or K/V not 16-byte aligned) or if it fails; on a CPU
    tensor it runs the plain version; on a ``meta`` tensor it returns the
    empty result. Reads nothing of kv_len on the host.
    """
    global launches
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len).contiguous()
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    _check_kernel(q, k, v)
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    splits, chunk = split_plan(B * KV, S, _sm_count(q.device.index or 0))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((B * KV, splits, H // KV, hd),
                             dtype=torch.float32, device=q.device)
        ml_part = torch.empty((B * KV, splits, H // KV, 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        decode_attention_cuda(q, k, v, kv_len.to(torch.int32).contiguous(),
                              out, o_part, ml_part, splits=splits,
                              chunk=chunk)
    launches += 1
    launches_by_variant[VARIANTS[q.dtype]] += 1
    return out
