"""Decode attention: one token's GQA attention over the unrepeated serving
cache, each row read up to its own length (no TPU counterpart)."""
from repro_torch.kernels.decode_attention.kernel import (  # noqa: F401
    decode_attention_cuda)
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_ref)
