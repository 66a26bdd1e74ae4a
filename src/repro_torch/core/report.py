"""Stage reports — the artifacts the ElasticAI-Workflow's feedback loop reads
(port of ``repro/core/report.py``; plain dataclasses, field for field).

Stage 1 (design/train)   -> DesignReport      (accuracy, quantization error)
Stage 2 (translate/synth)-> SynthesisReport   (resources, estimated time/energy)
Stage 3 (deploy/measure) -> MeasurementReport (measured time/energy)

The paper's Table I is exactly a (SynthesisReport, MeasurementReport) pair
for one accelerator.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict


@dataclass
class DesignReport:
    model: str
    train_loss: float
    eval_loss: float
    quant_rms_error: float = 0.0
    weight_fmt: str = ""
    act_fmt: str = ""
    params: int = 0
    notes: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


@dataclass
class SynthesisReport:
    """What "Vivado" (here: the cost model, or a host compile) estimates
    before deployment."""

    model: str
    target: str                      # hw spec name
    # resource utilization analogue
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    fits: bool = True
    utilization: float = 0.0         # peak bytes / device memory
    # timing/power estimation analogue
    flops: float = 0.0
    bytes_accessed: float = 0.0
    wire_bytes: float = 0.0
    est_latency_s: float = 0.0
    est_power_w: float = 0.0
    est_energy_j: float = 0.0
    est_gop_per_j: float = 0.0
    bottleneck: str = ""
    channels: Dict[str, float] = field(default_factory=dict)  # per-region s
    channel_joules: Dict[str, float] = field(default_factory=dict)
    compile_seconds: float = 0.0
    # RTL backend extras (host-target reports leave these at defaults)
    backend: str = "xla"
    resources: Dict[str, float] = field(default_factory=dict)  # dsp/bram/lut
    n_artifacts: int = 0             # emitted template files (rtl only)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


@dataclass
class MeasurementReport:
    """What the Elastic Node measures (here: wall-clock execution on the
    measuring substrate + the power model)."""

    model: str
    platform: str
    latency_s: float
    power_w: float
    energy_j: float
    gop_per_j: float = 0.0
    n_runs: int = 0
    target: str = ""                 # deployment-target name
    # tail latency: percentiles over the per-run execution latencies on the
    # measuring substrate. Deployment readiness is a tail question, not a
    # mean — Venieris et al. 2018 (PAPERS.md).
    latency_p50_s: float = 0.0
    latency_p99_s: float = 0.0
    per_channel_j: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


def compare(syn: SynthesisReport, meas: MeasurementReport) -> Dict[str, float]:
    """Estimation-vs-measurement deltas — the paper's Table I format."""
    def rel(est, m):
        return (est - m) / m if m else 0.0

    return {
        "latency_rel_err": rel(syn.est_latency_s, meas.latency_s),
        "power_rel_err": rel(syn.est_power_w, meas.power_w),
        "energy_rel_err": rel(syn.est_energy_j, meas.energy_j),
    }
