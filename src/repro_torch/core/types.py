"""Configuration dataclasses of the paper's two model families.

Port of the ``ModelConfig``/``LSTMConfig``/``Conv1dConfig`` part of
``repro/core/types.py``. The LM zoo's sub-configs and the parallelism and
shape tables wait for the slices that port those families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LSTMConfig:
    """The paper's own model family: LSTM for time-series (traffic flow)."""

    hidden: int = 20
    n_layers: int = 1
    in_features: int = 6           # lags of the traffic-flow series
    out_features: int = 1
    seq_len: int = 6


@dataclass(frozen=True)
class Conv1dConfig:
    """TCN-style depthwise conv stack for multichannel sensor windows:
    ``n_blocks`` depthwise, strided 1-D conv blocks (one ``kernel``-tap
    filter per channel) with a hard activation between, then a dense
    readout over the flattened final feature map."""

    channels: int = 3              # sensor channels (e.g. 3-axis IMU)
    seq_len: int = 16              # window length in samples
    kernel: int = 3                # taps per channel filter
    stride: int = 2
    n_blocks: int = 2
    out_features: int = 1
    act: str = "hard_tanh"

    def block_lens(self) -> Tuple[int, ...]:
        """Per-block output lengths: t' = (t - kernel)//stride + 1."""
        lens, t = [], self.seq_len
        for _ in range(self.n_blocks):
            t = (t - self.kernel) // self.stride + 1
            if t < 1:
                raise ValueError(
                    f"conv1d window collapses: seq_len={self.seq_len} "
                    f"kernel={self.kernel} stride={self.stride} "
                    f"n_blocks={self.n_blocks}")
            lens.append(t)
        return tuple(lens)

    @property
    def flat_features(self) -> int:
        """Input width of the dense head (last block length × channels)."""
        return self.block_lens()[-1] * self.channels


FAMILIES = ("lstm", "conv1d")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    lstm: Optional[LSTMConfig] = None
    conv1d: Optional[Conv1dConfig] = None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
