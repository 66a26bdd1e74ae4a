"""Nested context-manager spans on a monotonic clock — the tracing half.

The workflow's whole premise is a feedback loop, but until now a
``Workflow.run_once`` was a black box: one mean latency out, nothing about
where the time went. A :class:`Tracer` records *spans* — named, attributed,
nested intervals on a monotonic clock — so a run decomposes into
stage1 → stage2 → stage3 → verify, with emulator dispatches nested inside
the stage that issued them.

Design contract (DESIGN.md §11):

* **near-zero overhead when disabled** — the process-default tracer starts
  disabled; ``tracer.span(...)`` is guarded by one attribute check
  (``tracer.enabled``) and returns a shared no-op context manager, so
  instrumented hot paths (the emulator dispatch, the server tick) pay a
  function call and an attribute load, nothing else. Hot loops may hoist
  the check themselves (``if trc.enabled: ...``) to skip even the kwargs
  dict.
* **deterministic span trees in tests** — the clock is injectable
  (``Tracer(clock=...)``), so tests drive a fake counter and assert exact
  start/end/parentage.
* **single-threaded by design** — the span stack is per-tracer; the
  toolchain's pipelines are single-threaded, and a concurrent consumer
  should install one Tracer per thread.

Device intervals: a span opened with ``device=`` also records where the
work it enqueued ran on that device. On a CUDA device it records a timing
event on the device's current stream when it opens and when it closes (none
while the stream is being captured into a CUDA Graph) and never waits on
one; the events are placed on the tracer's clock against one anchor a
device (a synchronize and an event, at the device's first timed span), and
read lazily, when :attr:`Tracer.spans` is read after the device has
reached them. Elsewhere the work ran synchronously: the device interval is
the host interval.

Exporters: :func:`to_chrome_trace` emits Chrome trace-event JSON (the
``{"traceEvents": [...]}`` envelope, ``ph:"X"`` complete events with µs
timestamps) viewable in Perfetto / ``chrome://tracing``;
:func:`to_jsonl` emits one JSON object per span for line-oriented tooling;
:func:`from_chrome_trace` parses the Chrome form back (round-trip tested).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "span",
    "to_chrome_trace", "to_jsonl", "from_chrome_trace",
    "span_tree", "find_spans",
]


@dataclass
class Span:
    """One finished interval: ``[start, end]`` seconds on the tracer clock.

    ``parent_id`` links the nesting tree (``None`` for roots); ``attrs``
    carry the knobs/shapes/modes the instrumented site attached.
    ``dev_start``/``dev_end`` are the interval on the device of a span
    opened with ``device=``, on the same clock (``None`` otherwise, and
    until the device has reached the span's end).
    """

    name: str
    start: float
    end: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    dev_start: Optional[float] = None
    dev_end: Optional[float] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


class _NullSpan:
    """The shared disabled-path context manager: enters/exits to itself,
    swallows attribute updates. One instance for the whole process."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attrs(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()

#: what :meth:`Tracer._mark` returns for a device that runs synchronously
_HOST = object()


class _ActiveSpan:
    """A span being recorded; created by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "start",
                 "device", "_open")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 device: Any = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.device = device

    def __enter__(self) -> "_ActiveSpan":
        t = self._tracer
        self.parent_id = t._stack[-1].span_id if t._stack else None
        self.span_id = t._next_id
        t._next_id += 1
        t._stack.append(self)
        self.start = t.clock()
        self._open = None if self.device is None else t._mark(self.device)
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        mark = None if self._open is None else t._mark(self.device)
        end = t.clock()
        t._stack.pop()
        s = Span(name=self.name, start=self.start, end=end, attrs=self.attrs,
                 span_id=self.span_id, parent_id=self.parent_id)
        if mark is _HOST:
            s.dev_start, s.dev_end = s.start, s.end
        elif mark is not None:
            t._pending.append((s, self._open, mark))
        t._spans.append(s)
        return False

    def set_attrs(self, **attrs) -> None:
        """Attach values discovered mid-span (e.g. a cache-hit flag)."""
        self.attrs.update(attrs)


class Tracer:
    """Collects spans. ``enabled=False`` makes every call a no-op.

    ``clock`` must be monotonic; it defaults to :func:`time.perf_counter`
    and is injectable for deterministic tests.
    """

    __slots__ = ("enabled", "clock", "_spans", "_stack", "_next_id",
                 "_pending", "_anchors")

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self._spans: List[Span] = []         # finished, in completion order
        self._stack: List[_ActiveSpan] = []
        self._next_id = 1
        # (span, open mark, close mark) whose device times are not read yet
        self._pending: List[tuple] = []
        # CUDA device index -> (host clock, event) read together
        self._anchors: Dict[int, tuple] = {}

    @property
    def spans(self) -> List[Span]:
        """The finished spans, in completion order, each with its device
        interval where the device has reached its end."""
        if self._pending:
            self._read_device()
        return self._spans

    def span(self, name: str, *, device: Any = None, **attrs):
        """Context manager recording one nested span (no-op when disabled).
        With ``device`` (a ``torch.device`` or its name) the span also
        records its interval on that device (module doc)."""
        if not self.enabled:                 # the one-attribute-check guard
            return _NULL_SPAN
        return _ActiveSpan(self, name, attrs, device)

    def reset(self) -> None:
        self._spans = []
        self._stack = []
        self._next_id = 1
        self._pending = []

    # ------------------------------------------------------------------ #
    def _mark(self, device: Any):
        """A timing event on ``device``'s current stream with its device's
        anchor; :data:`_HOST` where the device is not CUDA; None while the
        stream is being captured."""
        if not str(device).startswith("cuda"):
            return _HOST
        import torch

        if torch.cuda.is_current_stream_capturing():
            return None
        index = torch.device(device).index
        if index is None:
            index = torch.cuda.current_device()
        anchor = self._anchors.get(index)
        if anchor is None:
            anchor = self._anchors[index] = self._anchor(index)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(index))
        return anchor, ev

    def _anchor(self, index: int) -> tuple:
        """The device's clock against the host's: with the device idle, a
        host reading and an event recorded right after it, waited for (its
        first record, which creates it, is made and waited for before the
        reading). An event recorded later on an idle stream so maps to no
        earlier than the host instant of its record."""
        import torch

        torch.cuda.synchronize(index)
        stream = torch.cuda.current_stream(index)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        ev.synchronize()
        host = self.clock()
        ev.record(stream)
        ev.synchronize()
        return host, ev

    def _read_device(self) -> None:
        """Device times of the pending spans whose end the device has
        reached; the rest stay pending."""
        left = []
        for item in self._pending:
            s, (anchor, ev0), (_, ev1) = item
            if not ev1.query():
                left.append(item)
                continue
            host, ref = anchor
            s.dev_start = host + ref.elapsed_time(ev0) / 1e3
            s.dev_end = host + ref.elapsed_time(ev1) / 1e3
        self._pending = left


#: Process default: disabled until someone opts in (``obs.capture`` or
#: ``set_tracer``); instrumented sites call ``get_tracer()`` every time so
#: an install is picked up immediately.
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process default; returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def span(name: str, **attrs):
    """Convenience: a span on the process-default tracer."""
    return _TRACER.span(name, **attrs)


# --------------------------------------------------------------------------- #
# Exporters
# --------------------------------------------------------------------------- #


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def to_chrome_trace(spans: Iterable[Span], *, pid: int = 1,
                    tid: int = 1) -> dict:
    """Chrome trace-event JSON (open in Perfetto / ``chrome://tracing``).

    Each span becomes a ``ph:"X"`` complete event; timestamps/durations are
    microseconds relative to the earliest span start. Span/parent ids ride
    in ``args`` so the exact tree survives the format.
    """
    spans = list(spans)
    t0 = min((s.start for s in spans), default=0.0)
    events = []
    for s in spans:
        args = {k: _json_safe(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "name": s.name, "ph": "X", "cat": "repro",
            "ts": (s.start - t0) * 1e6, "dur": s.duration * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_chrome_trace(doc: dict) -> List[Span]:
    """Parse :func:`to_chrome_trace` output back into spans (µs → s)."""
    spans = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        span_id = args.pop("span_id", 0)
        parent_id = args.pop("parent_id", None)
        start = ev["ts"] / 1e6
        spans.append(Span(name=ev["name"], start=start,
                          end=start + ev["dur"] / 1e6, attrs=args,
                          span_id=span_id, parent_id=parent_id))
    return spans


def to_jsonl(spans: Iterable[Span]) -> str:
    """One JSON object per span, newline-delimited."""
    lines = []
    for s in spans:
        lines.append(json.dumps({
            "name": s.name, "start": s.start, "end": s.end,
            "duration": s.duration, "span_id": s.span_id,
            "parent_id": s.parent_id,
            "attrs": {k: _json_safe(v) for k, v in s.attrs.items()},
        }, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------- #
# Tree helpers (tests + the human-readable summary)
# --------------------------------------------------------------------------- #


def find_spans(spans: Iterable[Span], name: str) -> List[Span]:
    return [s for s in spans if s.name == name]


def children_of(spans: Iterable[Span], parent: Span) -> List[Span]:
    return sorted((s for s in spans if s.parent_id == parent.span_id),
                  key=lambda s: s.start)


def span_tree(spans: Iterable[Span]) -> List[tuple]:
    """The nesting forest as ``(span, depth)`` pairs in start order."""
    spans = list(spans)
    roots = sorted((s for s in spans if s.parent_id is None),
                   key=lambda s: s.start)
    out: List[tuple] = []

    def walk(s: Span, depth: int) -> None:
        out.append((s, depth))
        for c in children_of(spans, s):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return out


def ancestors(spans: Iterable[Span], s: Span) -> List[Span]:
    """Parent chain of ``s``, nearest first."""
    by_id = {x.span_id: x for x in spans}
    out = []
    cur = s
    while cur.parent_id is not None and cur.parent_id in by_id:
        cur = by_id[cur.parent_id]
        out.append(cur)
    return out
