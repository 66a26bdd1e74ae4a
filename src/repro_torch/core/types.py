"""Configuration dataclasses: the paper's two model families and the LM
families dense, MoE, audio (encoder-decoder), VLM, hybrid (Mamba-2 with a
shared attention block) and RWKV.

Port of ``ModelConfig``/``MoEConfig``/``SSMConfig``/``RWKVConfig``/
``EncoderConfig``/``LSTMConfig``/``Conv1dConfig``, ``ShapeConfig`` with
the shape tables, ``MeshConfig`` with ``SINGLE_POD``/``MULTI_POD`` and
``ParallelismConfig`` from ``repro/core/types.py``. ``ParallelismConfig``
has every field of the reference's; its ``pipeline_stages`` and
``param_dtype``, which nothing reads, refuse any value but the default.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (routed + optional shared)."""

    n_experts: int
    top_k: int
    d_expert: int                  # per-routed-expert FFN hidden size
    n_shared: int = 0              # number of always-on shared experts
    d_shared: int = 0              # hidden size of EACH shared expert
    capacity_factor: float = 1.25  # per-expert token capacity multiplier
    aux_loss_coef: float = 0.01    # load-balance auxiliary loss weight
    router_dtype: str = "float32"  # router math always runs in f32
    impl: str = "psum"             # "psum" | "a2a" | "dense" (oracle)
    first_dense: int = 0           # number of leading dense (non-MoE) layers
    d_ff_dense: int = 0            # FFN hidden of those leading dense layers


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int = 64
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length (parallel scan blocking)
    conv_width: int = 4


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") block configuration."""

    head_size: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    chunk: int = 128               # chunked-recurrence block length


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (whisper)."""

    n_layers: int
    n_heads: int
    d_ff: int
    n_positions: int = 1500        # precomputed frame embeddings (stub frontend)


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


FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm", "lstm",
            "conv1d")
BLOCK_KINDS = ("attn", "moe", "mamba2", "rwkv6", "shared_attn")


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
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"                   # "rmsnorm" | "layernorm"
    act: str = "silu"                       # "silu" (swiglu) | "gelu" | "relu_sq"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None          # "audio" | "vision" (stub embeddings)
    n_frontend_tokens: int = 0              # visual/audio tokens prepended/encoded
    frontend_dim: int = 0                   # raw embedding dim from the stub
    shared_attn_every: int = 0              # zamba2: shared attn block cadence
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128
    dtype: str = "bfloat16"
    # Remat policy for the layer stack in training: "full" | "dots" | "none"
    remat: str = "full"
    # replicate the input embedding table over the "model" axis instead of
    # sharding its vocab (``layers.embed_schema``)
    embed_replicated: bool = False
    # chunk the CE loss over positions (the (B, S, V) logits are never
    # alive at once)
    ce_chunked: bool = True

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence (length n_layers)."""
        if self.family in ("lstm", "conv1d"):
            return ()
        if self.family == "ssm":
            return ("rwkv6",) * self.n_layers
        if self.family == "hybrid":
            return ("mamba2",) * self.n_layers
        if self.family == "moe":
            assert self.moe is not None
            k = ["attn"] * self.moe.first_dense
            k += ["moe"] * (self.n_layers - self.moe.first_dense)
            return tuple(k)
        return ("attn",) * self.n_layers

    def shared_attn_points(self) -> Tuple[int, ...]:
        """Layer indices AFTER which the zamba2 shared block is applied."""
        if self.shared_attn_every <= 0:
            return ()
        return tuple(i for i in range(self.n_layers)
                     if (i + 1) % self.shared_attn_every == 0)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter counts (used by the energy model / MODEL_FLOPS).
    def param_count(self) -> int:
        from repro_torch.model.layers import param_count
        from repro_torch.model.transformer import param_schema

        return param_count(param_schema(self))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe_layers = self.n_layers - m.first_dense
        inactive = (m.n_experts - m.top_k) * per_expert * n_moe_layers
        return total - inactive


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | ...
    kind: str                      # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Paper's own workload: one LSTM inference (time-series window).
SHAPES_LSTM = {
    "infer_1": ShapeConfig("infer_1", "prefill", 6, 1),
    "train_batch": ShapeConfig("train_batch", "train", 6, 64),
}

# TCN-style sensor workload: one conv1d inference (multichannel window).
SHAPES_CONV1D = {
    "infer_1": ShapeConfig("infer_1", "prefill", 16, 1),
    "train_batch": ShapeConfig("train_batch", "train", 16, 64),
}


def shape_table_for(cfg: ModelConfig) -> dict:
    """The {name: ShapeConfig} table this arch family draws from."""
    if cfg.family == "lstm":
        return SHAPES_LSTM
    if cfg.family == "conv1d":
        return SHAPES_CONV1D
    return SHAPES


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which assigned shapes run for this arch (skips documented in
    DESIGN.md)."""
    if cfg.family in ("lstm", "conv1d"):
        return tuple(shape_table_for(cfg))
    names = ("train_4k", "prefill_32k", "decode_32k")
    if cfg.family in ("ssm", "hybrid"):  # sub-quadratic: run long_500k
        names += ("long_500k",)
    return names


def skipped_shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family in ("ssm", "hybrid", "lstm", "conv1d"):
        return ()
    return ("long_500k",)


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names. The schema builders read it
    for the layouts (``PSpec.pspec``); ``launch/mesh.py`` builds the
    matching ``torch.distributed`` device mesh."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def tp_axis(self) -> str:
        return "model"

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axes, self.shape)).get(name, 1)


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
SMOKE_MESH = MeshConfig((1, 1), ("data", "model"))

ATTN_IMPLS = ("ref", "flash")


@dataclass(frozen=True)
class ParallelismConfig:
    """Runtime knobs of the LM path, the reference's fields.

    ``grad_compression``: on a mesh of more than one rank the train step
    reduces gradients over the data axes with the int8 butterfly
    (``optim/compress.py``); on one rank it is not read, as the
    reference's. ``pipeline_stages`` and ``param_dtype`` are the
    reference's fields, which nothing reads there either: any value but
    the default raises, so that neither can be set and silently ignored.

    ``seq_shard_decode`` shards a KV cache's sequence axis over ``"model"``
    where the KV heads do not divide it (a layout only). ``scan_layers``
    runs each group's stacked layers as one scan over the stack and keeps
    serving caches stacked (``{"g0": ..., "shared": ...}`` with a leading
    layer axis); the numbers are the unrolled path's. ``attn_impl``:
    ``"ref"`` (plain PyTorch einsum attention) or ``"flash"`` (the B5
    kernel for every causal prefill, whose plain version runs on a CPU
    tensor). ``gqa_grouped`` contracts q-head groups against unrepeated
    K/V instead of materialising repeated K/V.
    """

    grad_compression: bool = False
    pipeline_stages: int = 0
    seq_shard_decode: bool = False
    scan_layers: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "ref"
    gqa_grouped: bool = False

    def __post_init__(self):
        for name in ("pipeline_stages", "param_dtype"):
            default = type(self).__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"ParallelismConfig.{name}={getattr(self, name)!r}: "
                    f"only the default {default!r} (nothing reads it)")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        torch_dtype(self.compute_dtype)
