"""One telemetry plane for the whole pipeline.

Port of ``repro.obs`` with the reference's exports; the modules are the
reference's text with the imports moved to ``repro_torch``.

``repro_torch.obs`` is where every layer — serving front end, stream tree,
sharded refresh, kernel dispatch, checkpointing — reports what it did:
counters, gauges, latency histograms with exact percentiles, and
``trace(phase)`` wall-time spans, all snapshot-able to one plain dict
(``Session.stats()`` at the front door) and renderable as Prometheus
text (:func:`render_prometheus`).

Since schema v2 the plane is *explainable*, not just aggregate:
``trace(phase)`` spans executed under an active trace also land as
structured ``trace_id``/``span_id``/``parent_id`` records in a bounded
:class:`FlightRecorder` ring (export with :func:`dump_trace` — Chrome
trace-event JSON or JSON-lines), and a :class:`~repro_torch.obs.monitors.\
MonitorHub` of online monitors (outlier-rate drift vs the z/n budget,
model staleness, shed burn) emits typed ``Alert`` records into
``snapshot()["alerts"]``.

Disable metrics process-wide with ``REPRO_METRICS=0`` or
:func:`set_metrics_enabled`, tracing with ``REPRO_TRACE=0`` or
:func:`set_tracing_enabled`; instrumentation is timers and tallies only,
so results are bit-identical either way.
"""
from repro_torch.obs.registry import (DEFAULT_BUCKETS, DEFAULT_RING,
                                SNAPSHOT_VERSION, Counter, Gauge, Histogram,
                                MetricsRegistry, counter, gauge,
                                get_default_registry, histogram, metric_key,
                                metrics_enabled, record_comm,
                                set_default_registry, set_metrics_enabled,
                                snapshot, split_key, using_registry)
# ``trace`` is the combined histogram + flight-recorder span (degrades
# to histogram-only outside an active sampled trace).
from repro_torch.obs.tracing import (FlightRecorder, SpanContext, TraceSpec,
                               apply_trace_spec, configure_tracing,
                               current_context, dump_trace, export_chrome,
                               export_jsonl, get_default_recorder,
                               root_trace, set_tracing_enabled, trace,
                               tracing_enabled, use_context)
from repro_torch.obs.monitors import (Alert, MonitorHub, OutlierRateMonitor,
                                ShedRateMonitor, StalenessMonitor)
from repro_torch.obs.prom import render_prometheus

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_RING",
    "SNAPSHOT_VERSION",
    "Alert",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MonitorHub",
    "OutlierRateMonitor",
    "ShedRateMonitor",
    "SpanContext",
    "StalenessMonitor",
    "TraceSpec",
    "apply_trace_spec",
    "configure_tracing",
    "counter",
    "current_context",
    "dump_trace",
    "export_chrome",
    "export_jsonl",
    "gauge",
    "get_default_recorder",
    "get_default_registry",
    "histogram",
    "metric_key",
    "metrics_enabled",
    "record_comm",
    "render_prometheus",
    "root_trace",
    "set_default_registry",
    "set_metrics_enabled",
    "set_tracing_enabled",
    "snapshot",
    "split_key",
    "trace",
    "tracing_enabled",
    "use_context",
    "using_registry",
]
