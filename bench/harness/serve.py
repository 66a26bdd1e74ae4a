"""One run of a serving cell: set-up (weights drawn from the seed, a
warm-up on the cell's own shapes, a closed loop's pool admitted), then the
measured window, driving the program's ``Server`` through ``submit`` and
``step`` and stamping every token on the host clock.

* Open loop: a request is due at its scheduled time and is submitted at
  the first tick boundary after it; when nothing is queued or decoding,
  the loop sleeps until the next one is due.
* Closed loop: a client sends its next request at the tick boundary where
  its reply is done.

A token is stamped when the ``step()`` that appended it returns (the
step's ``.cpu()`` of the logits has synchronised by then); a first token
takes the server's own ``t_first_token``, stamped after the prefill's
logits reached the host. Both are ``time.perf_counter``.
"""
from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench.harness import program, traffic
from bench.harness.devtrace import DeviceTrace, Profiled


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``), where the system says."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Served:
    """A request as the window saw it."""

    req: traffic.Req
    rid: int
    due: float                      # host clock
    stamps: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class Run:
    """What a run recorded, for the metrics and the check."""

    t0: float
    t1: float
    setup_s: float
    served: List[Served]
    spans: List = field(default_factory=list)
    trace: Optional[DeviceTrace] = None
    profiled: Optional[tuple] = None    # host-clock (start, end) of the slice
    b5_launches_profiled: int = 0
    memory_peak_bytes: int = 0


class _AnnotatingSpan:
    def __init__(self, inner, mark):
        self._inner, self._mark = inner, mark

    def __enter__(self):
        self._mark.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc):
        out = self._inner.__exit__(*exc)
        self._mark.__exit__(*exc)
        return out


def annotating_tracer():
    """The program's ``Tracer``, each span also a profiler annotation of
    its name, so that the device trace can name what the host was doing."""
    import torch

    base = program.tracer_class()

    class AnnotatingTracer(base):
        __slots__ = ()

        def span(self, name, **attrs):
            return _AnnotatingSpan(super().span(name, **attrs),
                                   torch.profiler.record_function(name))

    return AnnotatingTracer()


def warm_up(cfg, params, config: Dict, mix: Dict, device) -> None:
    """One prefill at each of the mix's shortest, median and longest
    prompts and a few ticks of the full pool (a tick runs every slot, busy
    or not), on a server of the cell's size; its memory stays in the
    caching allocator for the window's server."""
    srv = program.new_server(cfg, params, config, mix["slots"],
                             mix["max_len"], device)
    for n in traffic.warm_lengths(mix):
        srv.submit(list(range(2, 2 + n)), max_new_tokens=3)
    srv.run_until_drained()
    _sync(device)
    del srv
    gc.collect()


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(cfg, params, config: Dict, mix: Dict, reqs: List[traffic.Req],
          seconds: float, device, trace: bool = False,
          server_cls=None) -> Run:
    """The measured window over ``reqs``; returns the record once the
    window has closed and the server is freed."""
    import torch

    on_card = torch.device(device).type == "cuda"
    srv = program.new_server(cfg, params, config, mix["slots"],
                             mix["max_len"], device, server_cls)
    by_rid: Dict[int, Served] = {}
    live: Dict[int, Served] = {}
    closed = mix["loop"] == "closed"

    def submit(r: traffic.Req, due: float) -> None:
        rid = srv.submit(r.prompt, max_new_tokens=r.out_len)
        s = Served(req=r, rid=rid, due=due)
        by_rid[rid] = live[rid] = s

    def stamp(now: float) -> List[Served]:
        finished = []
        for rid, s in list(live.items()):
            out = srv.requests[rid].out_tokens
            for k in range(len(s.tokens), len(out)):
                s.stamps.append(srv.requests[rid].t_first_token if k == 0
                                else now)
                s.tokens.append(int(out[k]))
            if srv.requests[rid].done:
                s.done = True
                finished.append(s)
                del live[rid]
        return finished

    queues: List[List[traffic.Req]] = []
    if closed:
        # the pool opens full: each client's first request (part-way
        # through its output where the mix says so) admitted in set-up
        # (one tick: its prefill and a first decode)
        n = mix["clients"]
        queues = [[r for r in reqs if r.client == c] for c in range(n)]
        now = time.perf_counter()
        for q in queues:
            submit(q.pop(0), now)
        srv.step()
        stamp(time.perf_counter())
    _sync(device)
    prof, slice_at = None, None
    if trace and on_card:
        # the profiler's first start sets up its tracing of the card
        # (seconds): do it here, not in the window
        warm = Profiled()
        warm.start()
        warm.stop(read=False)
    if trace:
        tracer = annotating_tracer()
        prev = program.set_tracer(tracer)
    t0 = time.perf_counter()
    setup_s = process_age()
    t1 = t0 + seconds
    pending = [] if closed else sorted(reqs, key=lambda r: r.due)
    nxt = 0
    if trace and on_card:
        # the device trace: the window's last seconds, on a card only; the
        # profiler stops, and its trace is read, once the window has closed
        slice_at = t1 - min(6.0, 0.3 * seconds)
    launches0 = 0
    while True:
        now = time.perf_counter()
        if now >= t1:
            break
        if slice_at is not None and prof is None and now >= slice_at:
            prof = Profiled()
            launches0 = program.b5_launches()
            prof.start()
            prof_t = time.perf_counter()
        while nxt < len(pending) and t0 + pending[nxt].due <= now:
            submit(pending[nxt], t0 + pending[nxt].due)
            nxt += 1
        if not live:
            wake = t0 + pending[nxt].due if nxt < len(pending) else t1
            time.sleep(max(0.0, min(wake, t1) - now))
            continue
        srv.step()
        for s in stamp(time.perf_counter()):
            if closed and queues[s.req.client]:
                submit(queues[s.req.client].pop(0), time.perf_counter())
    run_trace, profiled, launches = None, None, 0
    if prof is not None:
        run_trace = prof.stop()
        profiled = (prof_t, time.perf_counter())
        launches = program.b5_launches() - launches0
    _sync(device)
    spans = []
    if trace:
        program.set_tracer(prev)
        spans = list(tracer.spans)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # every request due in the window, answered or not
    for r in pending[nxt:]:
        if t0 + r.due <= t1:
            submit(r, t0 + r.due)
    del srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return Run(t0=t0, t1=t1, setup_s=setup_s, served=list(by_rid.values()),
               spans=spans, trace=run_trace, profiled=profiled,
               b5_launches_profiled=launches, memory_peak_bytes=peak)
