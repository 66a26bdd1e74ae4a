"""Hardware specs — the constants behind every estimate in the system (port
of ``repro/energy/hw.py``).

The XC7S15 entry reproduces the paper's Table-I platform field for field,
so the cost model and the measurement protocol compare like for like with
the reference. In place of the reference's TPU entry the port carries the
card it runs on, ``H100_SXM``: peak and bandwidth from NVIDIA's data sheet,
``active_w`` the 700 W power limit ``nvidia-smi`` reports for it; the idle
power is an assumption (marked), used only for energy-style reporting. It
is the default spec of ``Creator``, the host target and the roofline.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float            # FLOP/s (bf16 for a GPU; DSP MAC*2 for FPGA)
    hbm_bw: float                # bytes/s main-memory bandwidth
    link_bw: float               # bytes/s per device link (0: single device)
    vmem_bytes: int              # on-chip fast memory (shared memory / BRAM)
    hbm_bytes: int               # device memory capacity
    active_w: float              # power while computing
    idle_w: float                # power while gated/idle
    mxu_align: int = 128         # matmul tile alignment
    clock_hz: float = 0.0        # fabric clock (FPGA targets; 0 for a GPU)

    def energy_j(self, seconds: float, duty: float = 1.0) -> float:
        return seconds * (self.active_w * duty + self.idle_w * (1 - duty))


# One H100 SXM (NVIDIA's data sheet): 989 TFLOP/s dense bf16 on the tensor
# cores, 3.35 TB/s HBM3, 80 GiB; NVLink 4 is 18 links of 50 GB/s (both
# directions); 228 KiB of shared memory on each of 132 SMs.
H100_SXM = HWSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=50e9,
    vmem_bytes=132 * 228 * 1024,
    hbm_bytes=80 * 1024 ** 3,
    active_w=700.0,              # the power limit nvidia-smi reports
    idle_w=70.0,                 # ASSUMPTION
    mxu_align=64,                # wgmma's M tile
)

# The paper's platform: Spartan-7 XC7S15 @ 100 MHz (Table I).
# 20 DSP48 slices * 100 MHz * 2 OP/MAC = 4 GOP/s peak; 10 BRAM36 = 45 KiB.
XC7S15 = HWSpec(
    name="xc7s15",
    peak_flops=4e9,
    hbm_bw=0.4e9,                # BRAM-fed, effectively on-chip
    link_bw=0.0,
    vmem_bytes=45 * 1024,
    hbm_bytes=45 * 1024,
    active_w=0.071,              # Table I: 71 mW measured
    idle_w=0.010,
    clock_hz=100e6,              # Table I: 100 MHz fabric clock
)

# Named-spec lookup: manifests record ``hw`` by name; loaders resolve it
# back through here.
HW_BY_NAME = {spec.name: spec for spec in (H100_SXM, XC7S15)}


def get_hw(name: str) -> HWSpec:
    try:
        return HW_BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown HWSpec {name!r}; "
                       f"known: {sorted(HW_BY_NAME)}") from None
