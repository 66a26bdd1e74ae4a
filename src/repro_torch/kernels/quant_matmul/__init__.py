"""int8 matmul template (B4): int8 x int8 -> int32 with a f32 rescale."""
from repro_torch.kernels.quant_matmul.kernel import (  # noqa: F401
    quant_matmul_cuda)
from repro_torch.kernels.quant_matmul.ops import quant_matmul  # noqa: F401
from repro_torch.kernels.quant_matmul.ref import (  # noqa: F401
    int8_dot, quant_matmul_ref, quantize_act)
