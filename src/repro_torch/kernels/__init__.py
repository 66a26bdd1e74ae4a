"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference layout: ``kernel.py`` (the launcher that
binds a CUDA source of ``repro_torch/csrc/`` through ``ctypes``), ``ops.py``
(the public wrapper: checks its arguments, launches on a CUDA tensor, runs
the plain version on a CPU tensor, returns an empty result of the right
shape on a ``meta`` tensor, counts its launches and reports its work to a
step counter, :func:`reports`) and ``ref.py`` (the
plain PyTorch version, which also runs on CUDA). ``lstm_cell_int`` is the
RTL emulator's fused int32 LSTM window; ``mac_int`` the int32 MAC + requant
of the linear, conv1d and per-step LSTM templates; ``flash_attention`` the
LM's online-softmax attention forward, run by every causal prefill and
training layer (its gradient is the plain version's VJP);
``lstm_cell`` the float gate-fused LSTM window; ``quant_matmul`` the int8
matmul with its per-channel rescale; ``mamba2`` the Mamba-2 SSD chunk scan
(``csrc/ssd.cu``); ``rwkv6`` the RWKV-6 WKV recurrence (``csrc/wkv6.cu``).
The last four are reached through their public wrappers only, as in the
reference. ``decode_attention`` (:data:`PORT_KERNELS`) has no TPU
counterpart: one token's GQA attention over the serving cache, run by
every decode layer with ``attn_impl="flash"``.
"""

# the template library: the reference's ``repro.kernels.TEMPLATES`` plus
# ``mac_int``, which the reference keeps in ``rtl/oplib.py``
TEMPLATES = (
    "flash_attention",
    "lstm_cell",        # f32 fused LSTM window
    "lstm_cell_int",    # int32 fused LSTM window (RTL emulator hot path)
    "mac_int",          # int32 MAC + requant (RTL emulator)
    "mamba2",
    "quant_matmul",
    "rwkv6",
)

# kernels of the port that replace no TPU kernel, in the same layout
PORT_KERNELS = (
    "decode_attention",  # decode's GQA attention over the unrepeated cache
)


# --------------------------------------------------------------------------- #
# Work reports (beside the launch counters each ops.py keeps)
# --------------------------------------------------------------------------- #

#: the step counter a wrapper reports its calls to: ``energy/cost.py``
#: installs one while it counts a step, None otherwise
recorder = None


def reports(name: str, flops):
    """Decorator of a kernel's public wrapper: while a step counter is
    installed (:data:`recorder`), each call is reported to it as one op,
    ``name``, with ``flops(*args, **kwargs)`` and the bytes of its tensor
    arguments (each read once) and results (each written once), and the
    aten ops the wrapper issues inside it are not counted (its plain
    version on the CPU, the launcher's allocations on the card, the empty
    result on ``meta``). So a step counts the same on every device. With
    no counter installed the wrapper runs as it is."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        def reported(*args, **kwargs):
            if recorder is None:
                return fn(*args, **kwargs)
            return recorder.kernel(name, float(flops(*args, **kwargs)), fn,
                                   args, kwargs)

        return reported

    return wrap
