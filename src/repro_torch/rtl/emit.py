"""Template instantiation: IR graph -> named text artifacts (port of
``repro/rtl/emit.py``; the artifacts are the reference's, byte for byte).

``emit_graph`` walks the IR and asks each node's registered
:class:`~repro_torch.rtl.oplib.HWTemplate` to render its entity plus the
``.mem`` initialization files (weights/biases/LUT tables as two's-complement
hex, straight from ``fxp_to_int``), then wires the instances into a
top-level ``<design>.vhd``. A ``manifest.json`` records every edge's
Q-format so the emulator, the Elastic Node loader, and the artifacts stay
mutually consistent.

There is no per-op branching here (DESIGN.md §9): the walk is pure registry
dispatch, so a newly registered template emits without touching this module.
"""
from __future__ import annotations

import json
from typing import Dict

from repro_torch.rtl import templates as T
from repro_torch.rtl.ir import Graph
from repro_torch.rtl.oplib import get_template
from repro_torch.rtl.resources import node_cost


def _emit_top(graph: Graph, out: Dict[str, str]) -> None:
    """Wire the instances: combinational templates (LUT applications) tap
    their shared entity directly; sequential ones chain enable -> done."""
    compute = [(n, t) for n, t in ((n, get_template(n.op))
                                   for n in graph.nodes) if t.in_netlist]
    signals = [f"  signal {e.name} : std_logic_vector({e.bits}-1 downto 0);"
               for e in graph.edges.values()
               if e.name not in graph.inputs and e.name not in graph.outputs]
    instances = []
    seq_nodes = [n for n, t in compute if t.sequential]
    last_seq = seq_nodes[-1] if seq_nodes else None
    prev_done = "enable"
    for n, t in compute:
        if not t.sequential:                  # combinational: no handshake
            instances.append(t.instance(graph, n, enable="", done=""))
            continue
        done = "done" if n is last_seq else f"done_{n.name}"
        if done != "done":
            signals.append(f"  signal {done} : std_logic;")
        instances.append(t.instance(graph, n, enable=prev_done, done=done))
        prev_done = done
    x_e = graph.edges[graph.inputs[0]]
    y_e = graph.edges[graph.outputs[0]]
    out[f"{graph.name}.vhd"] = T.NETWORK.substitute(
        header=T.header(graph.name, graph.name), name=graph.name,
        x_width=x_e.bits, y_width=y_e.bits,
        signals="\n".join(signals), instances="".join(instances))


def _manifest(graph: Graph) -> str:
    per_node = {c.name: {"op": c.op, "cycles": c.cycles, "dsp": c.dsp,
                         "bram36": c.bram36, "lut": c.lut}
                for c in map(node_cost, graph.nodes)}
    return json.dumps({
        "design": graph.name,
        "inputs": graph.inputs, "outputs": graph.outputs,
        "edges": {e.name: {"shape": list(e.shape), "fmt": str(e.fmt)}
                  for e in graph.edges.values()},
        "nodes": per_node,
        "total_macs": graph.total_macs(),
    }, indent=2)


def emit_graph(graph: Graph) -> Dict[str, str]:
    """Render every node through its template; returns {filename: text}."""
    out: Dict[str, str] = {}
    for n in graph.nodes:
        get_template(n.op).emit(graph, n, out)
    _emit_top(graph, out)
    out["manifest.json"] = _manifest(graph)
    return out


def write_artifacts(artifacts: Dict[str, str], build_dir: str) -> None:
    import os

    os.makedirs(build_dir, exist_ok=True)
    for name, text in artifacts.items():
        with open(os.path.join(build_dir, name), "w") as f:
            f.write(text)
