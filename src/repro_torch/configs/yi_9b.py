"""Yi-9B — llama-arch GQA decoder. [arXiv:2403.04652; hf]"""
from repro_torch.core.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64_000,
        norm="rmsnorm",
        act="silu",
        rope_theta=5_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
