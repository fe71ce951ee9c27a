"""Telemetry of the port (port of ``repro/obs``): the span tracer and the
metrics registry.

  trace:   ``span("serve/batch")`` / ``@traced`` host spans ->
           Chrome-trace/Perfetto JSON; ``step_span`` brackets a
           ``torch.profiler.record_function`` range per step.
  metrics: process-wide ``MetricsRegistry``: counters, gauges, bounded
           p50/p95/p99 reservoirs, labeled series, snapshot/diff.

The reference's sinks (JSONL step log, ``summary.json``) and leveled log
are not ported yet. This package imports neither torch nor numpy at
module scope.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    diff,
    get_registry,
    reset_registry,
    series_key,
)
from .trace import Tracer, get_tracer, span, step_span, traced

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "diff",
    "get_registry", "reset_registry", "series_key",
    "Tracer", "get_tracer", "span", "step_span", "traced",
]
