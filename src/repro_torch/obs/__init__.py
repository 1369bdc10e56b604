"""Observability, torch port: span tracing, the metrics registry,
exporters, durable telemetry and the regression watchdog.

* :mod:`repro_torch.obs.tracer` — low-overhead span tracer (off by
  default), with wire-serializable :class:`TraceContext` for
  cross-process links;
* :mod:`repro_torch.obs.metrics` — one :class:`MetricsRegistry` for
  counters, gauges and fixed-bucket histograms, JSON + Prometheus exporters;
* :mod:`repro_torch.obs.export` — Chrome ``trace_event`` JSON (Perfetto),
  per-process span spill and the cross-process trace merge;
* :mod:`repro_torch.obs.telemetry` — bounded durable per-run history under
  the store root (:class:`TelemetryStore` / :class:`RunProfile`);
* :mod:`repro_torch.obs.watchdog` — :class:`RegressionDetector` comparing
  rolling telemetry windows to a recorded baseline.
"""

from .tracer import (TRACER, TRACE_ENV_VAR, Span, TraceContext, Tracer,
                     clear_spans, configure, disable, enable,
                     finished_spans, open_spans, span, tracing_mode)
from .export import (chrome_trace_json, load_spill, merge_process_traces,
                     spill_spans, to_chrome_trace, write_chrome_trace,
                     write_merged_trace)
from .metrics import (DEFAULT_BUCKETS, METRICS_SCHEMA_VERSION, REGISTRY,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      merge_node_snapshots, parse_prometheus_text,
                      snapshot_prometheus_text, validate_snapshot)
from .telemetry import TELEMETRY_SCHEMA_VERSION, RunProfile, TelemetryStore
from .watchdog import WATCHDOG_SERIES, RegressionDetector, WatchdogSignal

__all__ = [
    "TRACER", "TRACE_ENV_VAR", "Span", "TraceContext", "Tracer", "span",
    "configure", "enable", "disable", "tracing_mode", "finished_spans",
    "open_spans", "clear_spans",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "METRICS_SCHEMA_VERSION", "DEFAULT_BUCKETS", "validate_snapshot",
    "merge_node_snapshots", "snapshot_prometheus_text",
    "parse_prometheus_text",
    "to_chrome_trace", "chrome_trace_json", "write_chrome_trace",
    "spill_spans", "load_spill", "merge_process_traces",
    "write_merged_trace",
    "TelemetryStore", "RunProfile", "TELEMETRY_SCHEMA_VERSION",
    "RegressionDetector", "WatchdogSignal", "WATCHDOG_SERIES",
]
