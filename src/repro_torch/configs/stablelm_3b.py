"""StableLM-3B — dense MHA (kv == heads) decoder.

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.core.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50_304,
        norm="layernorm",
        act="silu",
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
