"""Mamba-2 SSD chunk-scan template (B6)."""
from repro_torch.kernels.mamba2.kernel import ssd_cuda  # noqa: F401
from repro_torch.kernels.mamba2.ops import ssd  # noqa: F401
from repro_torch.kernels.mamba2.ref import ssd_reference  # noqa: F401
