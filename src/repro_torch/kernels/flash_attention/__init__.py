"""Flash-attention forward template (B5): online-softmax attention."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
