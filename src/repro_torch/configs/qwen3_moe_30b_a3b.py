"""Qwen3-30B-A3B — 128-expert top-8 MoE with qk-norm GQA. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.core.types import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,                       # routed-expert hidden
        vocab_size=151_936,
        qk_norm=True,
        norm="rmsnorm",
        act="silu",
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512, vocab_pad_multiple=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32),
    )
