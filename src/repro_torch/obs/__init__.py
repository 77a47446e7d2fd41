"""Unified telemetry plane: metrics, simulated-time tracing, flight
recorder, and exporters: a copy of ``repro.obs`` (numpy only; the
catalog is ``docs/OBSERVABILITY.md``)."""
from .metrics import (HOST_COUNTERS, LINT_FIELD_ALLOWLIST, LatencyHistogram,
                      MetricsRegistry, host_counter_metric)
from .recorder import ANOMALY_KINDS, FlightRecorder
from .telemetry import ObsConfig, Telemetry, make_telemetry, merge_telemetry
from .tracing import SpanRecorder
from .export import (prometheus_text, render_report, telemetry_json,
                     write_chrome_trace)

__all__ = [
    "HOST_COUNTERS", "LINT_FIELD_ALLOWLIST", "LatencyHistogram",
    "MetricsRegistry", "host_counter_metric", "ANOMALY_KINDS",
    "FlightRecorder", "ObsConfig", "Telemetry", "make_telemetry",
    "merge_telemetry", "SpanRecorder", "prometheus_text", "render_report",
    "telemetry_json", "write_chrome_trace",
]
