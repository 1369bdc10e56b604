"""Observability, torch port: span tracing and the metrics registry.

* :mod:`repro_torch.obs.tracer` — low-overhead span tracer (off by default);
* :mod:`repro_torch.obs.metrics` — one :class:`MetricsRegistry` for
  counters, gauges and fixed-bucket histograms, JSON + Prometheus exporters.

The exporters, durable telemetry and the regression watchdog are not
ported yet (ROADMAP Queue 1).
"""

from .tracer import (TRACER, TRACE_ENV_VAR, Span, TraceContext, Tracer,
                     clear_spans, configure, disable, enable,
                     finished_spans, open_spans, span, tracing_mode)
from .metrics import (DEFAULT_BUCKETS, METRICS_SCHEMA_VERSION, REGISTRY,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      merge_node_snapshots, parse_prometheus_text,
                      snapshot_prometheus_text, validate_snapshot)
