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

**An Algorithm 3 fit's spans** (``core/distributed.py`` and below).
``oneshot.*`` spans are the phase level (``oneshot.site_summary`` and
``oneshot.second_level`` are also histograms in ``simulate_coordinator``);
the rest are detail spans (:func:`span`), recorded while a
``torch.profiler`` records.  Beside each, the question it answers::

    oneshot.fit               one fit's bounds; rank= on each rank of
    |                         distributed_cluster, so each rank's tree
    |                         is its own trace
    |- oneshot.site_summary   site=; in distributed_cluster, the ends
    |  |                      of the ranks' spans give each rank's wait
    |  |                      in the gather for the slowest site
    |  |- alg1.round          round=; how many rounds a site took, and
    |  |  |                   which round was slow
    |  |  |- sampler.draw     caller="alg1.sample", rows=: the draw
    |  |  |- alg1.distance    min_argmin's launch (its kernel, in the
    |  |  |                   profiler's rows, falls inside)
    |  |  |- alg1.radius      kthvalue and the capture: the radius
    |  |  |                   step's kernels fall inside
    |  |  '- alg1.readback    the host waiting for the card: a long one
    |  |                      says the round is bound on the device
    |  |- alg2.extra          Algorithm 2's extra centers, and their
    |  |  '- sampler.draw     caller="alg2.extra"
    |  '- alg2.reassign       the large min_argmin and the weights
    |- oneshot.gather         distributed_cluster: the collective's time
    |                         on this rank, the wait for the others in it
    '- oneshot.second_level
       |- kmeans_pp.seed      the seeding, against the Lloyd loop
       |  '- sampler.draw     caller="kmeans_pp.pick", k of them
       '- kmeans_mm.lloyd     the Lloyd iterations and the assignment

Every ``sampler.draw`` also adds to the ``sampler.draws{caller}`` and
``sampler.rows{caller}`` counters (rows: the logits' length, what the draw
reads; draws: how often each caller drew), and a categorical draw made on
a CUDA device to ``sampler.card_draws{caller}``: does every caller's draw
stay on the card, or does one (a sampler that draws on the host, logits
left on the CPU) copy its ids over?  The kernel ops add to
``kernels.pairs{op, route}`` (``kernels/dispatch.py``: ``count_pairs``):
the n m (row, center) pairs of each ``min_argmin`` and ``lloyd_step`` call,
by the route that served it (``rowscan``, ``tiled``, ``chunked`` on the
card, and the Lloyd step's ``centers``, ``rows``, ``serial``, ``chunked``;
``blocked`` or ``ref`` off it, where a blocked Lloyd step counts as its
assignment's ``min_argmin``): how much distance work a fit asks for, and
on which route?  The generic width's per-thread scan (d > 256) is reached
only by naming a route, as the route ladders do, so no counted call is
its.  Like ``sampler.rows``, it counts only while a span is live.  No span
synchronises with the device: a span around asynchronous work times the
host's side, and the device's side is read from the kernels that fall
inside it on the profiler's device rows.  Spans are stamped with
:func:`now`, a monotonic clock on ``torch.profiler``'s time line.

**Beside a profiler trace in Perfetto.**  Export the profiler's trace
(``prof.export_chrome_trace("prof.json")``), read its
``baseTimeNanoseconds``, write the recorder's spans on the same base
(``dump_trace("spans.json", base_ns=that)``), and append the second file's
``traceEvents`` to the first's: the spans then sit, one lane a trace,
above the profiler's host and device rows.
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
                               current_context, detail_on, dump_trace,
                               export_chrome, export_jsonl,
                               get_default_recorder, now, root_trace,
                               set_tracing_enabled, span, trace,
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
    "detail_on",
    "dump_trace",
    "export_chrome",
    "export_jsonl",
    "gauge",
    "get_default_recorder",
    "get_default_registry",
    "histogram",
    "metric_key",
    "metrics_enabled",
    "now",
    "record_comm",
    "render_prometheus",
    "root_trace",
    "set_default_registry",
    "set_metrics_enabled",
    "set_tracing_enabled",
    "snapshot",
    "span",
    "split_key",
    "trace",
    "tracing_enabled",
    "use_context",
    "using_registry",
]
