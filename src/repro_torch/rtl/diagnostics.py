"""Structured diagnostics for the static IR verifier (DESIGN.md §13; port of
``repro/rtl/diagnostics.py``).

The analyzer (:mod:`repro_torch.rtl.analyze`) reports everything it proves
— or fails to prove — as :class:`Diagnostic` records with *stable* rule
IDs, so CI gates and the ``repro_torch.rtl.lint`` CLI can key on
``EAI001`` forever, not on message text. The full run rolls up into an
:class:`AnalysisReport` that round-trips through JSON (``analysis.json`` is
written next to every saved RTL bundle).

Rule table (severity is the *default*; the analyzer never upgrades it):

=======  ========  ====================================================
EAI001   error     int32 accumulator overflow
EAI002   error     invalid requant shift (|s| > 31, or a widening shift
                   that leaves int32)
EAI003   error     Q-format discontinuity between an edge and a port
EAI004   error     LUT address range does not cover its input interval
EAI005   error     resource demand exceeds the device budget
EAI006   warning   output edge saturates (pre-clip interval exceeds fmt)
EAI007   warning   resource utilization above 90% of a budget
=======  ========  ====================================================
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"
_SEVERITIES = (SEVERITY_ERROR, SEVERITY_WARNING)


@dataclass(frozen=True)
class Rule:
    """One entry of the stable rule table: id, default severity, fix hint."""

    id: str
    severity: str
    title: str
    hint: str


RULES: Dict[str, Rule] = {r.id: r for r in (
    Rule("EAI001", SEVERITY_ERROR, "accumulator-overflow",
         "narrow the weight/activation formats (or reduce fan-in) so "
         "fan_in * max|w_int| * max|x_int| + |b_int| stays below 2**31; "
         "see ir.validate_formats"),
    Rule("EAI002", SEVERITY_ERROR, "requant-shift",
         "keep |in.frac + w.frac - out.frac| <= 31 and widening "
         "(negative) shifts small enough that the shifted accumulator "
         "still fits int32"),
    Rule("EAI003", SEVERITY_ERROR, "format-mismatch",
         "make the edge's FxpFormat equal to the port's format — the "
         "producer's out_fmt must equal the consumer's in_fmt on every "
         "wire"),
    Rule("EAI004", SEVERITY_ERROR, "lut-domain",
         "widen the LUT's in_fmt so its [lo, hi] address range covers "
         "the incoming interval, or requantize the producer to the "
         "LUT's input format"),
    Rule("EAI005", SEVERITY_ERROR, "resource-overflow",
         "shrink the design (narrower w_fmt, fewer taps/units) or "
         "target a larger device; see ResourceReport.utilization"),
    Rule("EAI006", SEVERITY_WARNING, "output-saturation",
         "widen the output edge's total_bits (or lower its frac_bits) "
         "so the worst-case accumulator fits without clipping"),
    Rule("EAI007", SEVERITY_WARNING, "resource-pressure",
         "over 90% of a device budget is committed; leave headroom for "
         "routing or choose a narrower format"),
)}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable rule id, severity, the node (and optionally the
    edge) it anchors to, a message, and the rule's fix hint."""

    rule: str
    severity: str
    node: str
    message: str
    edge: Optional[str] = None
    hint: str = ""

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def format(self, design: str = "") -> str:
        """One ruff-style line: ``design:node[:edge]: EAI00x message``."""
        where = f"{design}:{self.node}" if design else self.node
        if self.edge:
            where = f"{where}:{self.edge}"
        return f"{where}: {self.rule} [{self.severity}] {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "node": self.node, "message": self.message,
                "edge": self.edge, "hint": self.hint}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Diagnostic":
        return Diagnostic(rule=d["rule"], severity=d["severity"],
                          node=d["node"], message=d["message"],
                          edge=d.get("edge"), hint=d.get("hint", ""))


def make_diagnostic(rule: str, node: str, message: str,
                    edge: Optional[str] = None) -> Diagnostic:
    """Construct a Diagnostic with severity + hint drawn from the rule
    table; unknown rule ids raise listing the table (so a typo'd rule in a
    transfer function fails loudly, mirroring the registry errors)."""
    try:
        r = RULES[rule]
    except KeyError:
        raise ValueError(f"unknown diagnostic rule {rule!r}; known rules: "
                         f"{sorted(RULES)}") from None
    return Diagnostic(rule=rule, severity=r.severity, node=node,
                      message=message, edge=edge, hint=r.hint)


#: version stamp for the serialized report (bump on incompatible change)
ANALYSIS_FORMAT_VERSION = 1


@dataclass
class AnalysisReport:
    """The static verifier's artifact: per-edge integer intervals, the full
    diagnostic list, and the resource/cycle summary — JSON-round-trippable
    so ``analysis.json`` can gate CI without this repo's code."""

    design: str
    hw: str
    diagnostics: List[Diagnostic] = field(default_factory=list)
    #: edge name -> (lo, hi) integer-code interval proved by the analyzer
    intervals: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    resources: Dict[str, Any] = field(default_factory=dict)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == SEVERITY_WARNING]

    @property
    def passed(self) -> bool:
        """No error-severity diagnostics (warnings do not fail a design)."""
        return not self.errors

    def rules_fired(self) -> List[str]:
        return sorted({d.rule for d in self.diagnostics})

    def summary(self) -> str:
        verdict = "clean" if self.passed else "FAILED"
        return (f"{self.design}: static analysis {verdict} — "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s) over "
                f"{len(self.intervals)} edge(s)")

    def format(self) -> str:
        """The full ruff-style listing: one line per diagnostic (with its
        fix hint indented below), then the summary line."""
        lines = []
        for d in self.diagnostics:
            lines.append(d.format(self.design))
            if d.hint:
                lines.append(f"    hint: {d.hint}")
        lines.append(self.summary())
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format_version": ANALYSIS_FORMAT_VERSION,
            "design": self.design,
            "hw": self.hw,
            "passed": self.passed,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "intervals": {k: [int(lo), int(hi)]
                          for k, (lo, hi) in sorted(self.intervals.items())},
            "resources": dict(self.resources),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AnalysisReport":
        ver = d.get("format_version", ANALYSIS_FORMAT_VERSION)
        if ver != ANALYSIS_FORMAT_VERSION:
            raise ValueError(
                f"analysis report has format_version {ver}, this reader "
                f"understands {ANALYSIS_FORMAT_VERSION}")
        return AnalysisReport(
            design=d["design"], hw=d["hw"],
            diagnostics=[Diagnostic.from_dict(x)
                         for x in d.get("diagnostics", [])],
            intervals={k: (int(v[0]), int(v[1]))
                       for k, v in d.get("intervals", {}).items()},
            resources=dict(d.get("resources", {})))

    @staticmethod
    def from_json(text: str) -> "AnalysisReport":
        return AnalysisReport.from_dict(json.loads(text))
