"""InternVL2-1B — InternViT (STUB patch embeddings) + Qwen2-0.5B LM backbone.

``input_specs()`` provides precomputed (batch, 256, 1024) patch embeddings,
projected into the LM and prepended to the token sequence. [arXiv:2404.16821; hf]
"""
from repro_torch.core.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_655,
        norm="rmsnorm",
        act="silu",
        rope_theta=1_000_000.0,
        frontend="vision",
        n_frontend_tokens=256,
        frontend_dim=1024,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        n_frontend_tokens=8, frontend_dim=32,
    )
