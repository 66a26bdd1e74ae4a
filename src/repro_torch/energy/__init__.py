"""Hardware specs of the port (``hw``): the paper's XC7S15 and, in place of
the reference's TPU entry, the H100 the port runs on. The HLO-based
roofline and energy meter of the reference wait for the host-target slice.
"""
from repro_torch.energy.hw import H100_SXM, XC7S15, HWSpec  # noqa: F401
