"""Qwen3-32B — dense GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.core.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151_936,
        qk_norm=True,
        norm="rmsnorm",
        act="silu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
