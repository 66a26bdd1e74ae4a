"""The device's side of a traced run: ``torch.profiler`` over a fixed slice
of the window, its Chrome trace read back into kernel intervals, and what
they say: the device's busy seconds (the union of every kernel, copy and
memset), each kernel's seconds by name, and the idle gaps between them,
each named by what the host was doing at its middle (the outermost
benchmark or server span and the innermost operator)."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the annotation that marks the profiled slice
SLICE = "bench.profiled"
#: host operators looked at before an idle gap's middle to name it
LOOKBACK = 256


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    by_kernel: Dict[str, float] = field(default_factory=dict)
    kernel_count: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds_of(self, fragment: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name holds
        ``fragment``."""
        keys = [k for k in self.by_kernel if fragment in k]
        return (sum(self.by_kernel[k] for k in keys),
                sum(self.kernel_count[k] for k in keys))

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged intervals of (start, end) rows."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out)


def reduce(doc: Dict) -> DeviceTrace:
    """What the Chrome trace ``doc`` says of its :data:`SLICE`."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == SLICE]
    if len(marks) != 1:
        raise ValueError(f"the trace holds {len(marks)} '{SLICE}' spans")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    by_kernel: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    iv = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        by_kernel[e["name"]] += (b - a) * 1e-6
        count[e["name"]] += 1
        iv.append((a, b))
    busy = _union(np.array(iv, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0
    # idle gaps: before the first interval, between them, after the last
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gap = edges[:, 1] - edges[:, 0]
    ops = sorted((e for e in events if e.get("cat") in HOST_CATS
                  and e.get("cat") != "user_annotation"),
                 key=lambda e: float(e["ts"]))
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") != SLICE]
    os_ = np.array([float(e["ts"]) for e in ops])
    oe = os_ + np.array([float(e["dur"]) for e in ops])
    ss = np.array([float(e["ts"]) for e in spans])
    se = ss + np.array([float(e["dur"]) for e in spans])
    idle: Dict[str, float] = defaultdict(float)
    for i in np.nonzero(gap > 0)[0]:
        mid = 0.5 * (edges[i, 0] + edges[i, 1])
        # operators are short: those covering ``mid`` start among the
        # last LOOKBACK before it
        hi_ = int(np.searchsorted(os_, mid, side="right"))
        lo_ = max(0, hi_ - LOOKBACK)
        on = lo_ + np.nonzero(oe[lo_:hi_] >= mid)[0]
        over = np.nonzero((ss <= mid) & (se >= mid))[0]
        idle[_name([spans[j] for j in over] + [ops[j] for j in on])] += \
            float(gap[i]) * 1e-6
    return DeviceTrace(window_s=(hi - lo) * 1e-6, busy_s=busy_s,
                       by_kernel=dict(by_kernel), kernel_count=dict(count),
                       idle_by_host=dict(idle))


def _name(covering: List[Dict]) -> str:
    """The outermost span and the innermost operator among the host events
    covering one instant."""
    if not covering:
        return "(host idle)"
    spans = [e for e in covering if e.get("cat") == "user_annotation"]
    ops = [e for e in covering if e.get("cat") != "user_annotation"]
    outer = max(spans, key=lambda e: e["dur"])["name"] if spans else ""
    inner = min(ops, key=lambda e: e["dur"])["name"] if ops else ""
    return "/".join(x for x in (outer, inner) if x)


class Profiled:
    """``torch.profiler`` from :meth:`start` to :meth:`stop`, the slice
    marked by :data:`SLICE`; :meth:`stop` returns the reduced trace. The
    Chrome trace goes to a temporary file under ``TMPDIR`` and is deleted
    once read."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self._mark = None

    def start(self) -> None:
        prof = self._torch.profiler
        self._prof = prof.profile(activities=[prof.ProfilerActivity.CPU,
                                              prof.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = prof.record_function(SLICE)
        self._mark.__enter__()

    def stop(self, read: bool = True) -> Optional[DeviceTrace]:
        self._torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if not read:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        return reduce(doc)
