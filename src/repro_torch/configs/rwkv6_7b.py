"""RWKV6-7B ("Finch") — attention-free, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.core.types import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,                     # d_model / head_size
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65_536,
        norm="layernorm",
        act="relu_sq",                  # RWKV channel-mix uses relu^2
        rwkv=RWKVConfig(head_size=64, decay_lora=64, chunk=128),
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        rwkv=RWKVConfig(head_size=16, decay_lora=8, chunk=8),
    )
