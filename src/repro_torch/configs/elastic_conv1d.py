"""The conv1d sensor workload: TCN-style depthwise stack.

A 3-channel (IMU-like) 16-sample window through two depthwise, stride-2
conv blocks (3 taps/channel) with hard_tanh between, then a dense readout.
"""
from repro_torch.core.types import Conv1dConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="elastic-conv1d",
        family="conv1d",
        n_layers=2,
        d_model=3,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=0,
        conv1d=Conv1dConfig(channels=3, seq_len=16, kernel=3, stride=2,
                            n_blocks=2, out_features=1, act="hard_tanh"),
    )


def smoke() -> ModelConfig:
    return config()  # the paper's scale is smoke scale already
