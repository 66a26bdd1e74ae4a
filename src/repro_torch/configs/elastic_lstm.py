"""The paper's own accelerator workload: LSTM traffic-flow predictor.

Sized to match Table I / ref [11]: hidden=20, window=6, univariate input.
"""
from repro_torch.core.types import LSTMConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="elastic-lstm",
        family="lstm",
        n_layers=1,
        d_model=20,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=0,
        lstm=LSTMConfig(hidden=20, n_layers=1, in_features=1, out_features=1,
                        seq_len=6),
    )


def smoke() -> ModelConfig:
    return config()  # the paper's scale is smoke scale already
