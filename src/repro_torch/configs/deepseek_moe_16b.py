"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6.

First layer is dense (first_k_dense_replace=1, d_ff=10944). [arXiv:2401.06066; hf]
"""
from repro_torch.core.types import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,                      # routed-expert hidden
        vocab_size=102_400,
        norm="rmsnorm",
        act="silu",
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            d_expert=1408,
            n_shared=2,
            d_shared=1408,
            first_dense=1,
            d_ff_dense=10944,
        ),
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, vocab_pad_multiple=16,
        moe=MoEConfig(
            n_experts=8, top_k=2, d_expert=32, n_shared=2, d_shared=32,
            first_dense=1, d_ff_dense=128,
        ),
    )
