"""Oracle of B6: the per-step recurrence (``model/ssm.py``), as in
``repro/kernels/mamba2/ref.py``; it is also the kernel's plain version."""
from repro_torch.model.ssm import ssd_reference  # noqa: F401
