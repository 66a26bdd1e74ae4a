"""ElasticAI on PyTorch/CUDA — the port of the JAX package ``repro``.

The layout mirrors ``src/repro/`` module for module (``repro_torch/rtl/
emulator.py`` is the counterpart of ``repro/rtl/emulator.py``), and the
semantics are the reference's, integer for integer. Every Pallas kernel of
the reference becomes a kernel written by hand for Hopper (``csrc/``),
bound through ``ctypes`` and built at first use.

Entry points take an explicit ``device=``: ``None`` means ``"cuda"``, and a
host without CUDA raises instead of running elsewhere. The kernels' plain
PyTorch versions run only where the caller put the data on the CPU.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""
from repro_torch.device import resolve_device  # noqa: F401
