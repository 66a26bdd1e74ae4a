"""Whisper-tiny — encoder-decoder backbone; conv/mel frontend is a STUB.

``input_specs()`` feeds precomputed (batch, 1500, 384) frame embeddings to the
encoder per the brief. Positional scheme simplified to RoPE (backbone-only
reproduction; noted in DESIGN.md). [arXiv:2212.04356; unverified]
"""
from repro_torch.core.types import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,                     # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        norm="layernorm",
        act="gelu",
        frontend="audio",
        n_frontend_tokens=1500,
        frontend_dim=384,
        encoder=EncoderConfig(n_layers=4, n_heads=6, d_ff=1536, n_positions=1500),
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        n_frontend_tokens=16, frontend_dim=64,
        encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=128, n_positions=16),
    )
