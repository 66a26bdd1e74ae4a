"""StableLM-2-12B — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.core.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100_352,
        norm="layernorm",
        act="silu",
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
