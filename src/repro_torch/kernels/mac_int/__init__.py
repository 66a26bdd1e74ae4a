"""Integer MAC template (the linear/conv1d/per-step-LSTM "DSP array")."""
from repro_torch.kernels.mac_int.kernel import mac_int_cuda  # noqa: F401
from repro_torch.kernels.mac_int.ops import mac_int_op  # noqa: F401
from repro_torch.kernels.mac_int.ref import (mac_int_ref,  # noqa: F401
                                             matmul_int32)
