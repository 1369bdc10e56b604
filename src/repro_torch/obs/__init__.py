"""Observability, torch port: span tracing, the metrics registry,
durable telemetry and the regression watchdog.

* :mod:`repro_torch.obs.tracer` — low-overhead span tracer (off by default);
* :mod:`repro_torch.obs.metrics` — one :class:`MetricsRegistry` for
  counters, gauges and fixed-bucket histograms, JSON + Prometheus exporters;
* :mod:`repro_torch.obs.telemetry` — bounded durable per-run history under
  the store root (:class:`TelemetryStore` / :class:`RunProfile`);
* :mod:`repro_torch.obs.watchdog` — :class:`RegressionDetector` comparing
  rolling telemetry windows to a recorded baseline.

The Chrome-trace exporter is not ported yet (ROADMAP Queue 1 item 4).
"""

from .tracer import (TRACER, TRACE_ENV_VAR, Span, TraceContext, Tracer,
                     clear_spans, configure, disable, enable,
                     finished_spans, open_spans, span, tracing_mode)
from .metrics import (DEFAULT_BUCKETS, METRICS_SCHEMA_VERSION, REGISTRY,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      merge_node_snapshots, parse_prometheus_text,
                      snapshot_prometheus_text, validate_snapshot)
from .telemetry import TELEMETRY_SCHEMA_VERSION, RunProfile, TelemetryStore
from .watchdog import WATCHDOG_SERIES, RegressionDetector, WatchdogSignal
