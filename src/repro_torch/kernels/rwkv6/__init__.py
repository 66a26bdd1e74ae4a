"""RWKV-6 WKV chunked-recurrence template (B7)."""
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda  # noqa: F401
from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.rwkv6.ref import wkv6_reference  # noqa: F401
