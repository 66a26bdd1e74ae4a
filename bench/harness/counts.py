"""The operations and bytes of the kernels whose rooflines the benchmark
reports, from the shapes of the calls: what the function needs, each
input read once and each output written once (causal pairs only, K/V
unrepeated), whatever the kernel reads again.

Peaks: one H100 SXM's data sheet, dense bf16 on the tensor cores and HBM3.
"""
from __future__ import annotations

#: dense bf16 tensor-core peak, FLOP/s
BF16_FLOP_PER_S = 989e12
#: HBM bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def b5_flops(n: int, heads: int, hd: int) -> int:
    """Causal attention of ``n`` queries over ``n`` keys: QK^T and PV,
    2 hd flops each per scored pair and head."""
    return 4 * hd * heads * causal_pairs(n)


def b5_bytes(n: int, heads: int, kv_heads: int, hd: int,
             elem: int = 2) -> int:
    """q and o of every head, k and v of every kv head, ``elem`` bytes an
    element."""
    return elem * n * hd * (2 * heads + 2 * kv_heads)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two peaks'
    times."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
