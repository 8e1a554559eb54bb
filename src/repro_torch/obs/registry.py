"""Process-wide metrics registry: counters, gauges, histograms, phase spans.

Port of ``repro.obs.registry`` (the reference's text; it imports no JAX),
plus ``Histogram.observe``'s ``count``.

The paper's headline claims are *measured* claims — communication cost
(records moved per round), clustering cost, outlier recall — and a serving
deployment adds latency and staleness to that list.  Before this module
every layer kept its own ad-hoc numbers (an unbounded latency list in the
serving front end, a one-off ``RefreshStats`` tuple in the sharded
service, an inline ``comm_records`` float in the coordinator), so there
was no single snapshot of what a running ``Session`` was doing.  This is
that snapshot's home:

* :class:`Counter` — monotonically increasing total (requests served,
  comm records gathered, kernel dispatches);
* :class:`Gauge` — last-set value, or a callable evaluated at snapshot
  time (tree records held, model staleness);
* :class:`Histogram` — fixed-bucket distribution **plus a bounded ring
  buffer of recent raw samples**, so bucket counts are Prometheus-style
  cumulative totals while p50/p95/p99 are *exact* percentiles
  (``np.percentile``) over the most recent ``ring`` observations — no
  bucket-interpolation error, no unbounded memory;
* :meth:`MetricsRegistry.trace` — a ``with trace("refresh.fit"): ...``
  span recording wall time into the ``phase.refresh.fit`` histogram, the
  one idiom every pipeline phase (ingest -> leaf-flush -> merge-reduce;
  refresh: gather -> fit -> install; score: enqueue -> batch -> fused ->
  drain) is instrumented with.

Metrics are keyed by ``name{label=value,...}`` with sorted label keys, so
one family fans out over site id / summarizer / kernel backend / topology
without separate registries.  Everything is mutation-thread-safe (the
async-refresh worker and checkpoint writer threads record concurrently
with the ingest thread) and snapshots to ONE plain JSON-ready dict —
``repro_torch.obs.prom`` renders the same snapshot as Prometheus text.

Instrumentation is process-wide on by default; ``REPRO_METRICS=0`` (or
``set_metrics_enabled(False)``) turns every mutation into a no-op.  The
plane is timers and tallies only — it never touches RNG or math, so
scores are bit-identical with it on or off (asserted in
``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

SNAPSHOT_VERSION = 2

# Latency-oriented log-spaced bucket edges in seconds ("le" upper bounds).
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
DEFAULT_RING = 4096


def _sanitize_label(v) -> str:
    """Label values land inside the ``name{k=v,...}`` key and inside
    Prometheus quotes — strip the characters that would break either."""
    s = str(v)
    for ch in '{}=,"\n':
        s = s.replace(ch, "_")
    return s


def metric_key(name: str, labels: dict) -> str:
    """Canonical flattened key: ``name`` or ``name{k=v,...}``, label keys
    sorted so the same label set always produces the same key."""
    if not labels:
        return name
    inner = ",".join(f"{k}={_sanitize_label(labels[k])}"
                     for k in sorted(labels))
    return f"{name}{{{inner}}}"


def split_key(key: str) -> tuple[str, dict]:
    """Inverse of :func:`metric_key` (labels back as a dict)."""
    if key.endswith("}") and "{" in key:
        name, rest = key.split("{", 1)
        labels = dict(pair.split("=", 1) for pair in rest[:-1].split(","))
        return name, labels
    return key, {}


def _num(v):
    """int when integral (counters of records/bytes), float otherwise."""
    f = float(v)
    return int(f) if f.is_integer() else f


class Counter:
    """Monotonically increasing value; ``inc`` is atomic under its lock."""

    __slots__ = ("_registry", "_lock", "_value")

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-set value, or a callable evaluated lazily at snapshot time
    (``set_fn``) for quantities that are a function of *now*, like model
    staleness — a stored number would be stale the moment it was set."""

    __slots__ = ("_registry", "_lock", "_value", "_fn")

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self._lock = threading.Lock()
        self._value: Optional[float] = None
        self._fn: Optional[Callable[[], Optional[float]]] = None

    def set(self, value) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_fn(self, fn: Callable[[], Optional[float]]) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._fn = fn

    def get(self) -> Optional[float]:
        fn = self._fn
        if fn is not None:
            try:
                v = fn()
            except Exception:
                return None
            return None if v is None else float(v)
        return self._value


class Histogram:
    """Fixed buckets for the long-run shape, a bounded ring of recent raw
    samples for exact percentiles.

    ``count``/``sum``/``min``/``max``/bucket counts cover *every*
    observation since creation (or :meth:`reset`); ``percentile`` and the
    snapshot's p50/p95/p99 are ``np.percentile`` over the most recent
    ``ring`` samples — exact, bounded, and recency-weighted, which is what
    a serving dashboard wants anyway.
    """

    __slots__ = ("_registry", "_lock", "_edges", "_counts", "_ring",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, registry: "MetricsRegistry",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 ring: int = DEFAULT_RING):
        self._registry = registry
        self._lock = threading.Lock()
        self._edges = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._edges) + 1)   # +1: the +Inf bucket
        self._ring: deque = deque(maxlen=int(ring))
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, value: float, count: int = 1) -> None:
        """Record ``value`` ``count`` times: the state ``count`` calls
        would leave, the sum added in the same order, under one lock (a
        drained micro-batch records one latency per row of a block)."""
        if not self._registry.enabled or count < 1:
            return
        v = float(value)
        with self._lock:
            # "le" semantics: bucket i counts v <= edges[i]
            self._counts[bisect.bisect_left(self._edges, v)] += count
            self._ring.extend(itertools.repeat(v, count))
            self._count += count
            for _ in range(count):
                self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def percentile(self, q: float) -> Optional[float]:
        """Exact ``np.percentile`` over the recent-sample ring."""
        with self._lock:
            data = list(self._ring)
        if not data:
            return None
        return float(np.percentile(np.asarray(data, np.float64), q))

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._edges) + 1)
            self._ring.clear()
            self._count = 0
            self._sum = 0.0
            self._min = self._max = None

    @property
    def count(self) -> int:
        return self._count

    def snapshot_entry(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            data = list(self._ring)
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        buckets: dict[str, int] = {}
        running = 0
        for edge, c in zip(self._edges, counts):
            running += c
            buckets[format(edge, ".10g")] = running
        buckets["+Inf"] = running + counts[-1]
        if data:
            arr = np.asarray(data, np.float64)
            p50, p95, p99 = (float(np.percentile(arr, q))
                             for q in (50, 95, 99))
        else:
            p50 = p95 = p99 = None
        return {
            "count": int(count),
            "sum": float(total),
            "min": lo,
            "max": hi,
            "p50": p50,
            "p95": p95,
            "p99": p99,
            "buckets": buckets,
        }


class _Span:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class MetricsRegistry:
    """One process-wide home for every metric; snapshot to a plain dict.

    ``enabled=False`` (or env ``REPRO_METRICS=0`` for the process default)
    turns every mutation — ``inc``/``set``/``observe``/``trace`` — into a
    no-op while reads keep working, so instrumented code never branches on
    whether telemetry is on.
    """

    def __init__(self, enabled: Optional[bool] = None, *,
                 recorder=None, monitors=None):
        if enabled is None:
            enabled = os.environ.get("REPRO_METRICS", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        # Each registry carries its own flight recorder and monitor hub
        # so ``using_registry`` isolates trace/alert state exactly like
        # metric state.  Imported lazily: tracing/monitors import this
        # module at their top level.
        if recorder is None:
            from repro_torch.obs.tracing import FlightRecorder
            recorder = FlightRecorder()
        if monitors is None:
            from repro_torch.obs.monitors import MonitorHub
            monitors = MonitorHub()
        self.recorder = recorder
        self.monitors = monitors

    # ------------------------------------------------------------ metrics
    def counter(self, name: str, **labels) -> Counter:
        key = metric_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(self))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = metric_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(self))
        return g

    def histogram(self, name: str, *, buckets: Sequence[float] | None = None,
                  ring: int | None = None, **labels) -> Histogram:
        key = metric_key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(
                    self, buckets=buckets or DEFAULT_BUCKETS,
                    ring=ring or DEFAULT_RING))
        return h

    def trace(self, phase: str, **labels):
        """``with registry.trace("refresh.fit", site=0): ...`` — wall time
        of the block lands in the ``phase.refresh.fit{site=0}`` histogram."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self.histogram(f"phase.{phase}", **labels))

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """The ONE plain dict: every counter, gauge and histogram, keyed by
        ``name{label=value,...}``, JSON-serializable as-is.  Callable
        gauges are evaluated here."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "version": SNAPSHOT_VERSION,
            "enabled": self.enabled,
            "counters": {k: _num(c.value)
                         for k, c in sorted(counters.items())},
            "gauges": {k: g.get() for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot_entry()
                           for k, h in sorted(hists.items())},
            "alerts": self.monitors.snapshot_alerts(),
            "trace": self.recorder.snapshot_section(),
        }

    def reset(self) -> None:
        """Drop every metric (a fresh registry without re-plumbing refs
        held by long-lived callers is NOT possible — they keep their
        handles; prefer :func:`using_registry` for test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ----------------------------------------------------------- process default
_default_registry = MetricsRegistry()


def get_default_registry() -> MetricsRegistry:
    return _default_registry


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` process-wide; returns the previous default.
    Instrumented layers capture metric handles when they are constructed,
    so install the registry *before* building the service under test."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev


@contextlib.contextmanager
def using_registry(registry: MetricsRegistry):
    """Scoped :func:`set_default_registry` (test/bench isolation)."""
    prev = set_default_registry(registry)
    try:
        yield registry
    finally:
        set_default_registry(prev)


def set_metrics_enabled(flag: bool) -> bool:
    """Flip instrumentation on/off on the current default registry;
    returns the previous state."""
    reg = get_default_registry()
    prev = reg.enabled
    reg.enabled = bool(flag)
    return prev


def metrics_enabled() -> bool:
    return get_default_registry().enabled


# ------------------------------------------------- default-registry helpers
def counter(name: str, **labels) -> Counter:
    return get_default_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return get_default_registry().gauge(name, **labels)


def histogram(name: str, *, buckets: Sequence[float] | None = None,
              ring: int | None = None, **labels) -> Histogram:
    return get_default_registry().histogram(name, buckets=buckets, ring=ring,
                                            **labels)


def trace(phase: str, **labels):
    return get_default_registry().trace(phase, **labels)


def snapshot() -> dict:
    return get_default_registry().snapshot()


def record_comm(per_site_records: Sequence[int],
                per_site_bytes: Sequence[int], **labels) -> None:
    """THE one communication-accounting mechanism.

    Every gather path — the sharded stream refresh, the host-simulated
    coordinator, the shard_map one-shot — reports the same way: valid
    records (the paper's communication measure, Chen/Sun/Zhang 1805.09495)
    and padded payload bytes (what actually crosses the interconnect), per
    site, accumulated into ``comm.records{site=i}`` / ``comm.bytes{site=i}``
    counters plus a ``comm.rounds`` round counter.
    """
    reg = get_default_registry()
    if not reg.enabled:
        return
    for site, (n_rec, n_bytes) in enumerate(zip(per_site_records,
                                                per_site_bytes)):
        reg.counter("comm.records", site=site, **labels).inc(int(n_rec))
        reg.counter("comm.bytes", site=site, **labels).inc(int(n_bytes))
    reg.counter("comm.rounds", **labels).inc()
