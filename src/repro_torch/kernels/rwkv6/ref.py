"""Oracle of B7: the naive per-step WKV6 recurrence (``model/rwkv.py``), as
in ``repro/kernels/rwkv6/ref.py``; it is also the kernel's plain version."""
from repro_torch.model.rwkv import wkv6_reference  # noqa: F401
