"""Telemetry of the port (port of ``repro/obs``): span tracer, metrics
registry, sinks and the leveled log.

  trace:   ``span("train/step/data")`` / ``@traced`` host spans ->
           Chrome-trace/Perfetto JSON (``--trace OUT.json``); ``step_span``
           brackets a ``torch.profiler.record_function`` range per step.
  metrics: process-wide ``MetricsRegistry``: counters, gauges, bounded
           p50/p95/p99 reservoirs, labeled series, snapshot/diff.
  sinks:   JSONL step log + schema-validated end-of-run ``summary.json``
           (``--metrics-out DIR``).
  log:     leveled stderr progress lines (``REPRO_LOG_LEVEL``), keeping
           stdout machine-parseable.

This package imports neither torch nor numpy at module scope.
"""

from .log import log, log_level, set_log_level
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
from .sinks import (
    SCHEMA_VERSION,
    SUMMARY_SCHEMA,
    StepLogWriter,
    SummarySchemaError,
    build_summary,
    validate_summary,
    write_summary,
)
from .trace import Tracer, get_tracer, span, step_span, traced

__all__ = [
    "log", "log_level", "set_log_level",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "diff",
    "get_registry", "reset_registry", "series_key",
    "SCHEMA_VERSION", "SUMMARY_SCHEMA", "StepLogWriter",
    "SummarySchemaError", "build_summary", "validate_summary",
    "write_summary",
    "Tracer", "get_tracer", "span", "step_span", "traced",
]
