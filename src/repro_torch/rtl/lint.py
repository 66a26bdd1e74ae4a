"""``python -m repro_torch.rtl.lint`` — ruff-style CLI over the static IR
verifier (port of ``repro/rtl/lint.py``; same output, same exit codes).

Lowers the canonical design(s) and runs
:func:`repro_torch.rtl.analyze.analyze_graph` (DESIGN.md §13), printing one
diagnostic per line with its fix hint and a per-design summary. Exit-code
semantics for CI:

* ``0`` — every design analyzed clean at the failing severity
* ``1`` — at least one diagnostic at the failing severity (error by
  default; add ``--strict`` to fail on warnings too)
* ``2`` — usage error (argparse)

Examples::

    python -m repro_torch.rtl.lint --arch lstm
    python -m repro_torch.rtl.lint --arch lstm --arch conv1d --strict
    python -m repro_torch.rtl.lint --json out/analysis.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, List, Optional

from repro_torch.energy.hw import XC7S15
from repro_torch.rtl.analyze import analyze_graph
from repro_torch.rtl.diagnostics import AnalysisReport

#: CLI spelling -> registered arch id (the canonical shipped designs)
ARCH_ALIASES = {
    "lstm": "elastic-lstm",
    "conv1d": "elastic-conv1d",
}


def resolve_arch(name: str) -> str:
    """CLI arch spelling -> registry id; unknown spellings raise listing
    what IS accepted (registry convention)."""
    if name in ARCH_ALIASES:
        return ARCH_ALIASES[name]
    if name in ARCH_ALIASES.values():
        return name
    known = sorted(set(ARCH_ALIASES) | set(ARCH_ALIASES.values()))
    raise ValueError(f"unknown arch {name!r}; known archs: {known}")


def lint_archs(archs: Iterable[str]) -> List[AnalysisReport]:
    """Lower each canonical design and analyze it against the default
    fabric target (XC7S15)."""
    from repro_torch.verify.vectors import canonical_graph

    reports = []
    for arch in archs:
        graph, _, _ = canonical_graph(resolve_arch(arch))
        reports.append(analyze_graph(graph, hw=XC7S15))
    return reports


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.rtl.lint",
        description="Static IR verifier over the canonical RTL designs "
                    "(abstract-interpretation range/overflow, Q-format, "
                    "LUT-domain and resource checks).")
    p.add_argument("--arch", action="append", metavar="{lstm,conv1d}",
                   help="design to lint (repeatable; default: both)")
    p.add_argument("--json", metavar="PATH",
                   help="also write the reports as a JSON array to PATH")
    p.add_argument("--strict", action="store_true",
                   help="fail (exit 1) on warnings too, not just errors")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    archs = args.arch or sorted(ARCH_ALIASES)
    try:
        reports = lint_archs(archs)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for rep in reports:
        print(rep.format())
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump([r.to_dict() for r in reports], f, indent=2,
                      sort_keys=True)
            f.write("\n")
    failed = any((not r.passed) or (args.strict and r.warnings)
                 for r in reports)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
