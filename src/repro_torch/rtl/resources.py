"""Per-node FPGA resource counts + cycle model — the "Vivado estimation" half
(port of ``repro/rtl/resources.py``).

Targets the paper's platform (Spartan-7 XC7S15 @ 100 MHz, Table I): 20 DSP48
slices, 10 BRAM36, 8000 6-input LUTs. The cycle model is the serial-MAC
schedule of the emitted templates, calibrated once against ref [11]'s
measured LSTM accelerator (57.25 µs / window): the gate-fused LSTM template
time-multiplexes its window over ``LSTM_DSP`` MAC units, paying a state
update + pipeline refill per step. Power is duty-cycled through
:meth:`HWSpec.energy_j` — MAC/elementwise cycles at ``active_w``, pipeline
fill at ``idle_w`` (DESIGN.md §5–§6).

Since the op-library redesign (DESIGN.md §9) the per-op cost formulas live on
each :class:`~repro_torch.rtl.oplib.HWTemplate`; this module owns the shared
schedule constants, the :class:`NodeCost`/:class:`ResourceReport` datatypes,
and the graph-level ``estimate``/``synthesize`` roll-ups. ``node_cost`` is a
registry dispatch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.report import SynthesisReport
from repro_torch.energy.hw import HWSpec, XC7S15
from repro_torch.rtl.ir import Graph, Node

# Template schedule constants (one-time calibration vs ref [11], DESIGN.md §5)
LSTM_DSP = 2          # MAC units the gate-fused cell template instantiates
LINEAR_DSP = 1        # serial-MAC linear template
CONV_DSP = 1          # serial tap-MAC conv1d template (one DSP, BRAM taps)
PIPE = 8              # pipeline fill/drain cycles per template invocation
BRAM36_BITS = 36 * 1024
LUT_ROM_BITS = 64     # one LUT6 stores 64 bits of distributed ROM

XC7S15_DSP = 20
XC7S15_BRAM36 = 10
XC7S15_LUTS = 8000


@dataclass
class NodeCost:
    name: str
    op: str
    cycles: int          # total schedule length
    active_cycles: int   # cycles with MAC/elementwise work in flight
    dsp: int
    bram36: int
    lut: int

    @staticmethod
    def zero(name: str, op: str) -> "NodeCost":
        return NodeCost(name, op, 0, 0, 0, 0, 0)


@dataclass
class ResourceReport:
    design: str
    target: str
    per_node: List[NodeCost] = field(default_factory=list)
    clock_hz: float = 100e6

    @property
    def cycles(self) -> int:
        return sum(c.cycles for c in self.per_node)

    @property
    def active_cycles(self) -> int:
        return sum(c.active_cycles for c in self.per_node)

    @property
    def duty(self) -> float:
        return self.active_cycles / self.cycles if self.cycles else 0.0

    @property
    def dsp(self) -> int:
        return sum(c.dsp for c in self.per_node)

    @property
    def bram36(self) -> int:
        return sum(c.bram36 for c in self.per_node)

    @property
    def lut(self) -> int:
        return sum(c.lut for c in self.per_node)

    @property
    def latency_s(self) -> float:
        return self.cycles / self.clock_hz

    def utilization(self) -> Dict[str, float]:
        return {"dsp": self.dsp / XC7S15_DSP,
                "bram36": self.bram36 / XC7S15_BRAM36,
                "lut": self.lut / XC7S15_LUTS}

    def fits(self) -> bool:
        return all(v <= 1.0 for v in self.utilization().values())


def brams_for(bits: int) -> int:
    """BRAM36 blocks needed for ``bits`` of weight/bias storage."""
    if bits < 0:
        raise ValueError(f"brams_for needs bits >= 0, got {bits}")
    return max(1, math.ceil(bits / BRAM36_BITS)) if bits else 0


def node_cost(node: Node) -> NodeCost:
    """Registry dispatch: the node's template owns its cost formula."""
    from repro_torch.rtl.oplib import get_template

    return get_template(node.op).cost(node)


def estimate(graph: Graph, *, clock_hz: float = 100e6) -> ResourceReport:
    rep = ResourceReport(design=graph.name, target="xc7s15",
                         clock_hz=clock_hz)
    rep.per_node = [node_cost(n) for n in graph.nodes]
    return rep


def synthesize(graph: Graph, *, hw: HWSpec = XC7S15,
               model_flops: float = 0.0,
               n_artifacts: int = 0) -> SynthesisReport:
    """ResourceReport -> SynthesisReport, the stage-2 artifact the Workflow
    loop reads. Latency = cycles × clock; energy duty-cycled via HWSpec."""
    clock = hw.clock_hz or 100e6
    rr = estimate(graph, clock_hz=clock)
    latency = rr.latency_s
    energy = hw.energy_j(latency, duty=rr.duty)
    if not model_flops:
        model_flops = 2.0 * graph.total_macs()
    util = rr.utilization()
    weight_bits = sum(e.bits for e in graph.edges.values())
    return SynthesisReport(
        model=graph.name, target=hw.name, backend="rtl",
        argument_bytes=sum(graph.edges[e].bits for e in graph.inputs) // 8,
        output_bytes=sum(graph.edges[e].bits for e in graph.outputs) // 8,
        temp_bytes=weight_bits // 8,
        fits=rr.fits(), utilization=max(util.values()),
        flops=model_flops, bytes_accessed=float(weight_bits // 8),
        est_latency_s=latency,
        est_power_w=energy / latency if latency else 0.0,
        est_energy_j=energy,
        est_gop_per_j=(model_flops / 1e9) / energy if energy else 0.0,
        bottleneck="compute",
        resources={"dsp": rr.dsp, "bram36": rr.bram36, "lut": rr.lut,
                   "cycles": rr.cycles, "duty": round(rr.duty, 4),
                   **{f"util_{k}": round(v, 4) for k, v in util.items()}},
        n_artifacts=n_artifacts)
