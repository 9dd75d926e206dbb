"""Serving observability: structured tracing, live metrics, health HTTP
(the port's own copy of the JAX package's pure-Python ``serving/obs``).

Three parts, all host-side and zero-cost when unused:

  * ``TraceRecorder`` — fixed-capacity ring buffer of request-lifecycle and
    superstep-boundary spans, exportable as Chrome trace-event JSON
    (open in https://ui.perfetto.dev).  Engines take ``tracer=None``.
  * ``MetricsRegistry`` / ``instrument_engine`` — Prometheus-style
    counters/gauges/histograms fed by scrape-time callbacks over the
    engines' existing ``EngineStats``/scheduler state.
  * ``MetricsServer`` — stdlib HTTP endpoint serving ``/metrics``
    (Prometheus text), ``/metrics.json``, and ``/healthz`` (503 under
    backpressure/drain).
"""

from repro_torch.serving.obs.httpd import MetricsServer, PROM_CONTENT_TYPE
from repro_torch.serving.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    instrument_engine,
)
from repro_torch.serving.obs.trace import TraceRecorder

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "PROM_CONTENT_TYPE",
    "TraceRecorder",
    "instrument_engine",
]
