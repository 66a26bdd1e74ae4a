"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference layout: ``kernel.py`` (the launcher that
binds a CUDA source of ``repro_torch/csrc/`` through ``ctypes``), ``ops.py``
(the public wrapper: checks its arguments, launches on a CUDA tensor, runs
the plain version on a CPU tensor, counts its launches) and ``ref.py`` (the
plain PyTorch version, which also runs on CUDA). ``lstm_cell_int`` is the
RTL emulator's fused int32 LSTM window; ``mac_int`` the int32 MAC + requant
of the linear, conv1d and per-step LSTM templates; ``flash_attention`` the
LM's online-softmax attention forward, run by every causal prefill layer.
"""
