"""Spans, counters, gauges and latency histograms (the port's own copy of
``repro/obs``, which imports no JAX):

* :mod:`repro_torch.obs.trace`   — nested spans on an injectable clock, a
  process-default :class:`Tracer` that is a no-op until enabled, Chrome
  trace-event JSON and JSONL exporters;
* :mod:`repro_torch.obs.metrics` — counters, gauges, histograms;
* :mod:`repro_torch.obs.export`  — the :class:`RunTrace` artifact and
  :class:`capture`, which scopes an enabled tracer and a fresh registry to
  a ``with`` body.

Metric namespaces: ``rtl.*`` (emulator), ``measure.*``
(``Deployment.measure``), ``resilience.*`` (guards, fault injection),
``server.*`` (the batched LM server) and ``serving.*`` (the farm).
"""
from repro_torch.obs.export import RunTrace, capture  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, get_metrics,
                                     percentile, set_metrics)
from repro_torch.obs.trace import (Span, Tracer, ancestors,  # noqa: F401
                                   children_of, find_spans,
                                   from_chrome_trace, get_tracer, set_tracer,
                                   span, span_tree, to_chrome_trace, to_jsonl)
