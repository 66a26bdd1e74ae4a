"""Zamba2-7B — 81 Mamba2 layers + a shared attention block every 6 layers.

Shared-block weights are reused at each invocation (per-invocation LoRA
adapters omitted — simplification noted in DESIGN.md). [arXiv:2411.15242; unverified]
"""
from repro_torch.core.types import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,                     # shared-block MLP hidden
        vocab_size=32_000,
        norm="rmsnorm",
        act="silu",
        rope_theta=10_000.0,
        ssm=SSMConfig(d_state=64, expand=2, headdim=64),
        shared_attn_every=6,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, chunk=8, conv_width=4),
        shared_attn_every=2,
    )
