"""Request-level tracing: structured spans in a bounded flight recorder.

Port of ``repro.obs.tracing`` (the reference's text; it imports no JAX).

The metrics registry (:mod:`repro_torch.obs.registry`) answers *how much* —
aggregate counters and latency histograms.  This module answers *where
it went*: every instrumented phase can also record a structured span
(``trace_id`` / ``span_id`` / ``parent_id`` + wall-clock bounds) into an
in-memory **flight recorder** — a fixed-size ring that is cheap enough
to leave on in production and can be dumped after the fact as Chrome
trace-event JSON (loadable in Perfetto / ``chrome://tracing``) or
JSON-lines.

Design points:

- **Zero-alloc when disabled.** ``FlightRecorder.new_trace()`` returns
  ``None`` without taking a lock when tracing is off; every recording
  helper treats a ``None`` context as "do nothing".
- **Head sampling.** The keep/drop decision is made once, at the trace
  root, by a seeded ``random.Random`` — deterministic under test.
  Children inherit the decision through the propagated context.
- **Always-sample on error.** ``record_span(..., force=True)`` and
  ``record_event(..., force=True)`` bypass the sampling decision so
  shed rejections and worker-tick failures are always reconstructable.
- **Cross-thread propagation.** The current span context lives in a
  ``contextvars.ContextVar``; :func:`use_context` carries it explicitly
  across thread boundaries (the serving scheduler installs the client
  ticket's context around the worker tick so one request stitches
  admission -> queue wait -> tick -> fused score -> drain into ONE
  trace).

The module-level :func:`trace` is a drop-in upgrade of the registry's
histogram-only span: it observes the same ``phase.*`` histogram *and*
records a flight span when called under an active sampled trace, so
every existing ``obs.trace(...)`` call site participates in structured
tracing with no per-site changes.

**One clock with torch's profiler.**  Spans are stamped by :func:`now`:
``time.perf_counter()`` moved once, at import, onto Unix time, the origin
``torch.profiler`` stamps its events on (kineto maps its own clock there
too).  It is monotonic, so a duration never reads negative, and a
flight-recorder export lies on a profiler export's time line
(``export_chrome(base_ns=...)``), as do the spans of the other processes
of one machine.

**Detail spans.**  :func:`span` marks work below the phase level (an
Algorithm 1 round, a draw): it feeds no histogram and, unless a
``torch.profiler`` records, costs one check and returns a shared no-op.
While a profiler records it joins the caller's sampled trace where one is
open; ``span(..., root=True)`` (a fit) starts a trace of its own where
none is, so the recorder holds the whole tree.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import random
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

# ``_torch_profiler._is_profiler_enabled``: the flag torch sets while a
# profiler records, read without a call into C
from torch.autograd import profiler as _torch_profiler

from repro_torch.obs import registry as _registry

__all__ = [
    "now",
    "span",
    "detail_on",
    "SpanContext",
    "FlightRecorder",
    "TraceSpec",
    "trace",
    "root_trace",
    "use_context",
    "current_context",
    "get_default_recorder",
    "configure_tracing",
    "set_tracing_enabled",
    "tracing_enabled",
    "export_chrome",
    "export_jsonl",
    "dump_trace",
]

_DEFAULT_RING = 65536


_UNIX_OFFSET = time.time() - time.perf_counter()


def now() -> float:
    """Seconds on a monotonic clock whose origin is Unix time's, the one
    ``torch.profiler`` stamps its events on (module docstring)."""
    return time.perf_counter() + _UNIX_OFFSET


class SpanContext(NamedTuple):
    """Propagated identity of the active span within a trace.

    ``sampled`` is the head-sampling decision made at the trace root;
    children never re-roll it.
    """

    trace_id: int
    span_id: int
    sampled: bool


_current: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("repro_trace_ctx", default=None)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Config-artifact knobs for the flight recorder (``tracing:``)."""

    enabled: bool = True
    sample_rate: float = 1.0
    ring: int = _DEFAULT_RING
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= float(self.sample_rate) <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {self.sample_rate}")
        if int(self.ring) < 1:
            raise ValueError(f"ring must be >= 1, got {self.ring}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": bool(self.enabled),
            "sample_rate": float(self.sample_rate),
            "ring": int(self.ring),
            "seed": int(self.seed),
        }


class FlightRecorder:
    """Bounded in-memory ring of structured spans and instant events.

    Thread-safe.  All timestamps are :func:`now` floats (Unix seconds,
    the profiler's clock); export writes them as microseconds after
    ``base_ns`` (Chrome) or as seconds (JSONL).
    """

    def __init__(self, enabled: Optional[bool] = None, *,
                 sample_rate: Optional[float] = None,
                 ring: Optional[int] = None,
                 seed: Optional[int] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "1") != "0"
        if sample_rate is None:
            sample_rate = float(os.environ.get("REPRO_TRACE_SAMPLE", "1.0"))
        if ring is None:
            ring = int(os.environ.get("REPRO_TRACE_RING", str(_DEFAULT_RING)))
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.ring = int(ring)
        self.seed = 0 if seed is None else int(seed)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring)
        self._rng = random.Random(self.seed)
        self._next_id = 1
        self._traces = 0
        self._recorded = 0
        self._dropped = 0

    # -- identity ----------------------------------------------------------

    def alloc_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
        return i

    def new_trace(self) -> Optional[SpanContext]:
        """Start a trace: allocate ids and make the sampling decision.

        Returns ``None`` (no lock, no allocation) when disabled.  The
        sampler is only consulted for rates strictly inside (0, 1) so
        the rng stream — and therefore the sampled set under a fixed
        seed — is a pure function of the root-creation order.
        """
        if not self.enabled:
            return None
        with self._lock:
            tid = self._next_id
            sid = self._next_id + 1
            self._next_id += 2
            if self.sample_rate >= 1.0:
                sampled = True
            elif self.sample_rate <= 0.0:
                sampled = False
            else:
                sampled = self._rng.random() < self.sample_rate
            self._traces += 1
        return SpanContext(tid, sid, sampled)

    # -- recording ---------------------------------------------------------

    def record_span(self, name: str, ctx: Optional[SpanContext], *,
                    t0: float, t1: float,
                    span_id: Optional[int] = None,
                    parent_id: Optional[int] = None,
                    status: str = "ok",
                    force: bool = False,
                    attrs: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """Append one completed span; returns its span id or ``None``.

        Skipped unless the trace was sampled or ``force`` is set
        (errors and shed rejections force-record so incidents survive
        any sampling rate).
        """
        if ctx is None or not self.enabled:
            return None
        if not (ctx.sampled or force):
            return None
        if span_id is None:
            span_id = self.alloc_id()
        rec = {
            "kind": "span",
            "name": name,
            "trace_id": ctx.trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "t0": t0,
            "t1": t1,
            "status": status,
            "attrs": dict(attrs) if attrs else {},
        }
        self._append(rec)
        return span_id

    def record_event(self, name: str,
                     ctx: Optional[SpanContext] = None, *,
                     force: bool = False,
                     attrs: Optional[Dict[str, Any]] = None) -> bool:
        """Append an instant event (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return False
        if not (force or (ctx is not None and ctx.sampled)):
            return False
        t = now()
        rec = {
            "kind": "event",
            "name": name,
            "trace_id": ctx.trace_id if ctx is not None else 0,
            "span_id": self.alloc_id(),
            "parent_id": ctx.span_id if ctx is not None else None,
            "t0": t,
            "t1": t,
            "status": "ok",
            "attrs": dict(attrs) if attrs else {},
        }
        self._append(rec)
        return True

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)
            self._recorded += 1

    # -- inspection --------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        out = [r for r in self.records() if r["kind"] == "span"]
        if name is not None:
            out = [r for r in out if r["name"] == name]
        return out

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        out = [r for r in self.records() if r["kind"] == "event"]
        if name is not None:
            out = [r for r in out if r["name"] == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def snapshot_section(self) -> Dict[str, Any]:
        """The ``trace`` section of ``snapshot()`` schema v2."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "sample_rate": self.sample_rate,
                "ring": self.ring,
                "recorded": self._recorded,
                "buffered": len(self._ring),
                "dropped": self._dropped,
                "traces": self._traces,
            }

    # -- export ------------------------------------------------------------

    def _kept(self, records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Drop records whose parent chain left the ring (orphans).

        The ring evicts oldest-first, so a long-lived root can be
        evicted while its children survive; exporting those children
        would break the "every span's parent exists" invariant the
        trace validator checks, so they are filtered here.
        """
        by_id = {r["span_id"]: r for r in records if r["kind"] == "span"}
        memo: Dict[int, bool] = {}

        def keep(rec: Dict[str, Any]) -> bool:
            sid = rec["span_id"]
            if sid in memo:
                return memo[sid]
            chain = []
            cur: Optional[Dict[str, Any]] = rec
            ok = True
            while cur is not None:
                cid = cur["span_id"]
                if cid in memo:
                    ok = memo[cid]
                    break
                chain.append(cid)
                pid = cur["parent_id"]
                if pid is None:
                    break
                cur = by_id.get(pid)
                if cur is None:
                    ok = False
            for cid in chain:
                memo[cid] = ok
            return ok

        return [r for r in records if keep(r)]

    def export_chrome(self, base_ns: int = 0) -> Dict[str, Any]:
        """Chrome trace-event JSON (``ph: "X"`` complete events).

        Each trace gets its own ``tid`` row so stitched requests read
        as one lane in Perfetto / ``chrome://tracing``.  ``ts`` is in
        microseconds after ``base_ns`` on the profiler's clock: pass a
        ``torch.profiler`` export's ``baseTimeNanoseconds`` and the events
        fall where that export's do (``obs`` package docstring).
        """
        base = base_ns * 1e-9
        records = self.records()
        kept = self._kept(records)
        events: List[Dict[str, Any]] = []
        for r in kept:
            args = {
                "trace_id": r["trace_id"],
                "span_id": r["span_id"],
                "parent_id": r["parent_id"],
                "status": r["status"],
            }
            args.update(r["attrs"])
            ev: Dict[str, Any] = {
                "name": r["name"],
                "ts": round(max(r["t0"] - base, 0.0) * 1e6, 3),
                "pid": 0,
                "tid": r["trace_id"],
                "args": args,
            }
            if r["kind"] == "span":
                ev["ph"] = "X"
                ev["dur"] = round(max(r["t1"] - r["t0"], 0.0) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        events.sort(key=lambda e: (e["ts"], e["args"]["span_id"]))
        with self._lock:
            dropped = self._dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": int(base_ns),
            "otherData": {
                "dropped_spans": dropped,
                "orphaned_spans": len(records) - len(kept),
            },
        }

    def export_jsonl(self) -> str:
        """One JSON object per record, Unix-time timestamps."""
        lines = []
        for r in self._kept(self.records()):
            out = dict(r)
            t0 = out.pop("t0")
            t1 = out.pop("t1")
            out["ts"] = round(t0, 6)
            out["dur_s"] = round(max(t1 - t0, 0.0), 9)
            lines.append(json.dumps(out, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str | Path, fmt: str = "chrome",
             base_ns: int = 0) -> Path:
        path = Path(path)
        if fmt == "chrome":
            path.write_text(json.dumps(self.export_chrome(base_ns)))
        elif fmt == "jsonl":
            path.write_text(self.export_jsonl())
        else:
            raise ValueError(f"unknown trace format {fmt!r}; "
                             f"expected 'chrome' or 'jsonl'")
        return path


# -- context propagation ----------------------------------------------------

def current_context() -> Optional[SpanContext]:
    return _current.get()


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]) -> Iterator[Optional[SpanContext]]:
    """Install ``ctx`` as the current span context (no-op for ``None``).

    This is the explicit cross-thread carry: a worker thread that
    processes work submitted elsewhere wraps the processing in
    ``use_context(ticket_ctx)`` so spans it opens stitch into the
    submitter's trace.
    """
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextlib.contextmanager
def root_trace(name: str, **attrs: Any) -> Iterator[Optional[SpanContext]]:
    """Start a new trace rooted at a span named ``name``."""
    rec = get_default_recorder()
    ctx = rec.new_trace()
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    t0 = now()
    status = "ok"
    try:
        yield ctx
    except BaseException as e:
        status = "error"
        attrs = dict(attrs)
        attrs["error"] = type(e).__name__
        raise
    finally:
        _current.reset(token)
        rec.record_span(name, ctx, t0=t0, t1=now(),
                        span_id=ctx.span_id, parent_id=None,
                        status=status, force=status == "error",
                        attrs=attrs)


class _DualSpan:
    """Span that feeds both the phase histogram and the flight recorder.

    Installs itself as the current context so nested ``trace()`` calls
    parent correctly.
    """

    __slots__ = ("_reg", "_rec", "_outer", "_name", "_labels",
                 "_ctx", "_token", "_t0")

    def __init__(self, reg: "_registry.MetricsRegistry",
                 rec: FlightRecorder, outer: SpanContext,
                 name: str, labels: Dict[str, Any]) -> None:
        self._reg = reg
        self._rec = rec
        self._outer = outer
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_DualSpan":
        self._ctx = SpanContext(self._outer.trace_id, self._rec.alloc_id(),
                                True)
        self._token = _current.set(self._ctx)
        self._t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = now()
        _current.reset(self._token)
        if self._reg.enabled:
            self._reg.histogram(f"phase.{self._name}",
                                **self._labels).observe(t1 - self._t0)
        attrs = dict(self._labels)
        status = "ok"
        if exc_type is not None:
            status = "error"
            attrs["error"] = exc_type.__name__
        self._rec.record_span(self._name, self._outer, t0=self._t0, t1=t1,
                              span_id=self._ctx.span_id,
                              parent_id=self._outer.span_id,
                              status=status, force=status == "error",
                              attrs=attrs)
        return False


def trace(phase: str, **labels: Any):
    """Combined histogram + flight-recorder span.

    Outside an active sampled trace this degrades to the registry's
    histogram-only span (one contextvar read of extra cost), so the
    hot path stays within the obs overhead budget.
    """
    reg = _registry.get_default_registry()
    ctx = _current.get()
    if ctx is not None and ctx.sampled and reg.recorder.enabled:
        return _DualSpan(reg, reg.recorder, ctx, phase, labels)
    return reg.trace(phase, **labels)


class _Off:
    """What :func:`span` returns when it is not live: ``with`` binds None."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def detail_on() -> bool:
    """True where :func:`span` is live: while a ``torch.profiler``
    records.  Instrumented code asks it before work that only a live span
    needs (a counter's labels)."""
    return _torch_profiler._is_profiler_enabled


class _Span:
    """A live :func:`span`: a flight-recorder span where a sampled trace
    is open (or ``root`` starts one); installs its context so nested
    spans parent under it."""

    __slots__ = ("_name", "_attrs", "_root", "_rec", "_outer", "_ctx",
                 "_token", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any], root: bool) -> None:
        self._name = name
        self._attrs = attrs
        self._root = root

    def __enter__(self) -> "_Span":
        rec = self._rec = get_default_recorder()
        outer = self._outer = _current.get()
        ctx = None
        if outer is not None:
            if outer.sampled and rec.enabled:
                ctx = SpanContext(outer.trace_id, rec.alloc_id(), True)
        elif self._root:
            ctx = rec.new_trace()
        self._ctx = ctx
        self._token = _current.set(ctx) if ctx is not None else None
        self._t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = now()
        if self._token is not None:
            _current.reset(self._token)
        ctx = self._ctx
        if ctx is not None and ctx.sampled:
            attrs, status = self._attrs, "ok"
            if exc_type is not None:
                attrs, status = dict(attrs), "error"
                attrs["error"] = exc_type.__name__
            self._rec.record_span(
                self._name, ctx, t0=self._t0, t1=t1, span_id=ctx.span_id,
                parent_id=None if self._outer is None else self._outer.span_id,
                status=status, attrs=attrs)
        return False


def span(name: str, *, root: bool = False, **attrs: Any):
    """A detail span (module docstring): no histogram; ``attrs`` land on
    the flight-recorder record.  Where :func:`detail_on` is False it costs
    that check and returns a no-op (``with`` binds None).  ``root=True``
    starts a trace of its own where no trace is open."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs, root)


# -- default-recorder front door --------------------------------------------

def get_default_recorder() -> FlightRecorder:
    return _registry.get_default_registry().recorder


def configure_tracing(*, enabled: Optional[bool] = None,
                      sample_rate: Optional[float] = None,
                      ring: Optional[int] = None,
                      seed: Optional[int] = None) -> FlightRecorder:
    """Replace the default registry's recorder with a reconfigured one."""
    rec = FlightRecorder(enabled, sample_rate=sample_rate, ring=ring,
                         seed=seed)
    _registry.get_default_registry().recorder = rec
    return rec


def apply_trace_spec(spec: TraceSpec) -> FlightRecorder:
    """Apply a config-artifact :class:`TraceSpec` to the default plane."""
    return configure_tracing(enabled=spec.enabled,
                             sample_rate=spec.sample_rate,
                             ring=spec.ring, seed=spec.seed)


def set_tracing_enabled(flag: bool) -> bool:
    rec = get_default_recorder()
    prev = rec.enabled
    rec.enabled = bool(flag)
    return prev


def tracing_enabled() -> bool:
    return get_default_recorder().enabled


def export_chrome(base_ns: int = 0) -> Dict[str, Any]:
    return get_default_recorder().export_chrome(base_ns)


def export_jsonl() -> str:
    return get_default_recorder().export_jsonl()


def dump_trace(path: str | Path, fmt: str = "chrome",
               base_ns: int = 0) -> Path:
    return get_default_recorder().dump(path, fmt, base_ns)
