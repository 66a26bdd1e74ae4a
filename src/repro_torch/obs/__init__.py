"""Spans, counters, gauges and latency histograms (the port's own copy of
``repro/obs/trace.py`` and ``repro/obs/metrics.py``, which import no JAX).

The ``RunTrace`` artifact and ``capture`` of ``repro/obs/export.py`` wait
for the operations slice (ROADMAP A9); a caller records spans by installing
a ``Tracer`` with ``set_tracer``. Metric namespaces used so far:
``server.*`` (the batched LM server), ``rtl.emulator.dispatch.<mode>``
(emulator runs) and ``measure.latency_s.rtl`` (``RTLExecutable.measure``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, get_metrics,
                                     percentile, set_metrics)
from repro_torch.obs.trace import (Span, Tracer, ancestors,  # noqa: F401
                                   children_of, find_spans,
                                   from_chrome_trace, get_tracer, set_tracer,
                                   span, span_tree, to_chrome_trace, to_jsonl)
