"""Continuous-batching scheduler with admission control over one engine.

Port of ``repro.serve.scheduler`` (the reference's text; it imports no
JAX).  On the card the worker thread's tick launches the ``score`` kernel
on the device's current stream; client threads only enqueue host rows.

The scheduler/worker split in front of ``ServingFrontEnd``: many client
threads ``submit()`` score requests concurrently; a single worker thread
pops them in ticks — lingering up to ``batch_window_ms`` so requests from
*different* clients coalesce — and scores each tick through the engine's
existing micro-batched read path (ONE fused score-kernel dispatch per
micro-batch — pdist + argmin + threshold divide in a single pass via
``repro_torch.kernels.score`` — padded to a static shape, so the hot path
keeps one shape).  Because the
scoring kernel computes every row independently and every micro-batch is
padded to the same static shape, a row's result is bit-identical no
matter which requests it shared a tick with — the concurrent path returns
exactly what sequential ``submit``+``drain`` would (asserted in
``tests/test_torch_serving.py``).

Admission control (:class:`repro_torch.serve.spec.ServingSpec`):

* the queue is bounded by ``queue_bound``; when full, ``shed_policy``
  either resolves the request *immediately* with a typed
  :class:`ShedReject` (``"shed"`` — overload costs goodput, not p99) or
  blocks the submitting client until space frees (``"wait"`` —
  backpressure);
* ``tenant_quota`` caps any one tenant's share of the queue, so a noisy
  tenant saturates its quota, not the service.

Every admitted request yields a :class:`ScoreTicket`; ``ticket.result()``
returns the engine's ``QueryResult`` (or the ``ShedReject``), re-raising
a worker-side failure on the *caller's* thread — a poison request never
kills the worker loop.

Telemetry (``repro_torch.obs``): ``serve.queue_depth`` gauge,
``serve.admitted{tenant=}`` / ``serve.completed{tenant=}`` /
``serve.shed{tenant=,reason=}`` counters, ``serve.batch_occupancy``
histogram (batched rows / max_batch per tick), ``serve.ticks`` counter,
and per-tenant end-to-end latency in
``serve.latency{tenant=,topology=scheduler}``.

Tracing: every submitted row starts a trace in the flight recorder;
its lifecycle spans (``serve.request`` root, ``serve.admission``,
``serve.queue_wait``, ``serve.tick``) are recorded from timestamps the
scheduler stamps on the ticket, so an unsampled request costs two id
allocations and nothing else.  The worker carries the first sampled
ticket's context across the thread boundary (``obs.use_context``)
around the engine submit/drain, so that request's trace stitches
admission -> queue wait -> tick -> ``score.fused`` -> drain into ONE
timeline.  ``ShedReject`` and worker-tick errors are force-recorded
(they bypass sampling) with the rejecting tenant and live queue depth.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import deque
from typing import NamedTuple, Optional

import numpy as np

from repro_torch import obs
from repro_torch.serve.spec import ServingSpec

# occupancy is a fraction of max_batch — latency buckets would waste edges
_OCCUPANCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

# the serve.queue_depth gauge is process-global (one registry, one series),
# while schedulers come and go with Sessions — so the gauge reads the *sum*
# over live schedulers rather than whichever instance registered last, and
# close() (or gc) removes an instance from the sum
_live_lock = threading.Lock()
_live_schedulers: "weakref.WeakSet[ServingScheduler]" = weakref.WeakSet()


def _total_queue_depth() -> int:
    with _live_lock:
        return sum(len(s._queue) for s in _live_schedulers)


class ShedReject(NamedTuple):
    """Typed admission rejection — a *result*, not an exception.

    ``reason`` is ``"queue_full"`` (the shared queue hit ``queue_bound``),
    ``"tenant_quota"`` (this tenant hit its quota) or ``"shutdown"`` (the
    scheduler was closed while the request waited for admission).
    ``queue_depth`` is the depth observed at the rejection.
    """
    request_id: int
    tenant: str
    reason: str
    queue_depth: int


class ScoreTicket:
    """One submitted row's pending result.

    ``result()`` blocks until the worker resolves the ticket and returns
    either the engine's ``QueryResult`` or a :class:`ShedReject`; a
    worker-side exception is re-raised here, on the caller's thread.
    """

    __slots__ = ("request_id", "tenant", "t_submit", "t_admit",
                 "t_dequeue", "t_done", "_event", "_value", "_error",
                 "_trace")

    def __init__(self, request_id: int, tenant: str):
        self.request_id = request_id
        self.tenant = tenant
        self.t_submit = obs.now()   # the flight recorder's clock
        self.t_admit: Optional[float] = None    # stamped at enqueue
        self.t_dequeue: Optional[float] = None  # stamped when a tick pops it
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._trace = None                      # SpanContext or None

    def _resolve(self, value) -> None:
        self.t_done = obs.now()
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self.t_done = obs.now()
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not scored within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def shed(self) -> bool:
        return isinstance(self._value, ShedReject)

    @property
    def latency_s(self) -> Optional[float]:
        """Admission -> resolution wall time (None while pending)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class ServingScheduler:
    """Async request queue + worker loop over one ``ServingFrontEnd``.

    The scheduler *owns* its engine's read path: every engine access —
    the worker's per-tick ``submit``/``drain``, but also any synchronous
    caller going around the queue (``Session.score`` / ``ingest`` /
    ``refresh`` while serving is active) — must hold ``engine_lock``.
    The ``Session`` facade routes its verbs through that lock whenever a
    scheduler is attached.

    The worker thread starts lazily on the first ``submit`` (or via
    ``start()``); ``close()`` drains what was already admitted, resolves
    every ticket, and joins the worker.  A scheduler with
    ``autostart=False`` queues without scoring until ``start()`` — tests
    use this to exercise admission control deterministically.
    """

    def __init__(self, engine, spec: Optional[ServingSpec] = None, *,
                 autostart: bool = True):
        self.engine = engine
        self.spec = spec if spec is not None else ServingSpec()
        self.engine_lock = threading.RLock()
        self.max_batch = (self.spec.max_batch
                          if self.spec.max_batch is not None
                          else int(engine.cfg.micro_batch))
        self._cond = threading.Condition()
        self._queue: deque = deque()        # (ticket, row (d,) f32)
        self._pending: dict[str, int] = {}  # queued-per-tenant (quota)
        self._inflight = 0                  # popped, not yet resolved
        self._next_id = 0
        self._stop = False
        self._autostart = autostart
        self._worker: Optional[threading.Thread] = None
        self.peak_depth = 0                 # high-water mark of len(_queue)
        # ---------------------------------------------------------- metrics
        with _live_lock:
            _live_schedulers.add(self)
        self._depth_gauge = obs.gauge("serve.queue_depth")
        self._depth_gauge.set_fn(_total_queue_depth)
        self._ticks = obs.counter("serve.ticks")
        self._occupancy = obs.histogram("serve.batch_occupancy",
                                        buckets=_OCCUPANCY_BUCKETS)
        self._worker_errors = obs.counter("serve.worker_errors")
        self._by_tenant: dict = {}
        self._shed_counters: dict = {}
        reg = obs.get_default_registry()
        self._recorder = reg.recorder
        self._monitors = reg.monitors

    def _tenant_metrics(self, tenant: str):
        m = self._by_tenant.get(tenant)
        if m is None:
            m = (obs.counter("serve.admitted", tenant=tenant),
                 obs.counter("serve.completed", tenant=tenant),
                 obs.histogram("serve.latency", tenant=tenant,
                               topology="scheduler"))
            self._by_tenant[tenant] = m
        return m

    def _count_shed(self, tenant: str, reason: str) -> None:
        c = self._shed_counters.get((tenant, reason))
        if c is None:
            c = obs.counter("serve.shed", tenant=tenant, reason=reason)
            self._shed_counters[(tenant, reason)] = c
        c.inc()

    # ------------------------------------------------------------ tracing
    def _record_shed(self, ticket: ScoreTicket, reason: str,
                     depth: int) -> None:
        """Force-record a shed so overload incidents survive sampling."""
        self._recorder.record_event(
            "serve.shed", ticket._trace, force=True,
            attrs={"request_id": ticket.request_id, "tenant": ticket.tenant,
                   "reason": reason, "queue_depth": depth})
        self._record_ticket_trace(ticket, "shed")

    def _record_ticket_trace(self, ticket: ScoreTicket, status: str,
                             tick_span_id: Optional[int] = None,
                             batch_size: Optional[int] = None) -> None:
        """Record a resolved ticket's lifecycle spans from its stamps.

        Spans are written retroactively (not opened live) so pending
        tickets carry only timestamps; non-ok statuses force-record.
        """
        tctx = ticket._trace
        if tctx is None:
            return
        force = status != "ok"
        if not (tctx.sampled or force):
            return
        rec = self._recorder
        rec.record_span(
            "serve.request", tctx, t0=ticket.t_submit, t1=ticket.t_done,
            span_id=tctx.span_id, parent_id=None, status=status, force=force,
            attrs={"request_id": ticket.request_id, "tenant": ticket.tenant})
        if ticket.t_admit is None:
            return
        rec.record_span("serve.admission", tctx, t0=ticket.t_submit,
                        t1=ticket.t_admit, parent_id=tctx.span_id,
                        force=force)
        if ticket.t_dequeue is None:
            return
        rec.record_span("serve.queue_wait", tctx, t0=ticket.t_admit,
                        t1=ticket.t_dequeue, parent_id=tctx.span_id,
                        force=force)
        attrs = {} if batch_size is None else {"batch": batch_size}
        rec.record_span("serve.tick", tctx, t0=ticket.t_dequeue,
                        t1=ticket.t_done, span_id=tick_span_id,
                        parent_id=tctx.span_id, status=status, force=force,
                        attrs=attrs)

    # ------------------------------------------------------------ admission
    def submit(self, points, *, tenant: str = "default") -> list[ScoreTicket]:
        """Admit query rows; returns one (possibly pre-resolved) ticket per
        row, in row order.  Validation errors raise here, on the caller —
        a malformed row never reaches the worker."""
        x, _ = self.engine._validate_points(points, None)
        # start the worker *before* admission: a "wait"-policy submit
        # larger than the queue bound blocks until ticks free space, which
        # only a running worker can do
        if self._worker is None and self._autostart:
            self.start()
        admitted_c, _, _ = self._tenant_metrics(tenant)
        spec = self.spec
        tickets: list[ScoreTicket] = []
        n_admitted = 0
        n_shed = 0
        with self._cond:
            for row in x:
                ticket = ScoreTicket(self._next_id, tenant)
                self._next_id += 1
                ticket._trace = self._recorder.new_trace()
                tickets.append(ticket)
                if self._stop:
                    depth = len(self._queue)
                    ticket._resolve(ShedReject(ticket.request_id, tenant,
                                               "shutdown", depth))
                    self._count_shed(tenant, "shutdown")
                    self._record_shed(ticket, "shutdown", depth)
                    n_shed += 1
                    continue
                reason = self._admission_block(tenant)
                if reason is not None and spec.shed_policy == "wait":
                    while reason is not None and not self._stop:
                        self._cond.wait(0.05)
                        reason = self._admission_block(tenant)
                    if self._stop:
                        reason = "shutdown"
                if reason is not None:
                    depth = len(self._queue)
                    ticket._resolve(ShedReject(ticket.request_id, tenant,
                                               reason, depth))
                    self._count_shed(tenant, reason)
                    self._record_shed(ticket, reason, depth)
                    n_shed += 1
                    continue
                ticket.t_admit = obs.now()
                self._queue.append((ticket, row))
                self._pending[tenant] = self._pending.get(tenant, 0) + 1
                n_admitted += 1
                if len(self._queue) > self.peak_depth:
                    self.peak_depth = len(self._queue)
            if n_admitted:
                self._cond.notify_all()   # wake the worker (and waiters)
        if n_admitted:
            admitted_c.inc(n_admitted)
        if n_admitted or n_shed:
            self._monitors.observe_admission(n_admitted, n_shed)
        return tickets

    def _admission_block(self, tenant: str) -> Optional[str]:
        """Why this tenant cannot enqueue right now (None = admitted).
        Caller holds ``_cond``."""
        if len(self._queue) >= self.spec.queue_bound:
            return "queue_full"
        q = self.spec.tenant_quota
        if q is not None and self._pending.get(tenant, 0) >= q:
            return "tenant_quota"
        return None

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ worker
    def start(self) -> None:
        """Start the worker thread (idempotent)."""
        with self._cond:
            if self._worker is not None or self._stop:
                return
            self._worker = threading.Thread(
                target=self._loop, name="serve-scheduler", daemon=True)
            self._worker.start()

    def _loop(self) -> None:
        window_s = self.spec.batch_window_ms / 1e3
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.1)
                if not self._queue and self._stop:
                    return
                # continuous batching: linger up to the batch window so
                # requests arriving from other clients join this tick
                if window_s > 0 and len(self._queue) < self.max_batch:
                    deadline = time.perf_counter() + window_s
                    while len(self._queue) < self.max_batch:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0 or self._stop:
                            break
                        self._cond.wait(remaining)
                take = min(self.max_batch, len(self._queue))
                batch = [self._queue.popleft() for _ in range(take)]
                t_pop = obs.now()
                for ticket, _ in batch:
                    ticket.t_dequeue = t_pop
                    self._pending[ticket.tenant] -= 1
                self._inflight += take
                self._cond.notify_all()   # queue space freed: wake waiters
            try:
                self._score_batch(batch)
            finally:
                with self._cond:
                    self._inflight -= len(batch)
                    self._cond.notify_all()

    def _score_batch(self, batch) -> None:
        """One tick: score the popped requests through the engine's
        micro-batched read path and resolve their tickets.  Engine errors
        resolve the tick's tickets (re-raised at ``result()``) and leave
        the loop alive for the next tick."""
        self._ticks.inc()
        self._occupancy.observe(len(batch) / self.max_batch)
        rows = np.stack([row for _, row in batch])
        # cross-thread stitch: carry the first sampled ticket's trace into
        # the engine work so its score.enqueue/batch/fused/drain spans nest
        # under this tick (one "primary" per tick keeps the worker O(1))
        rec = self._recorder
        primary: Optional[ScoreTicket] = None
        tick_span_id: Optional[int] = None
        for ticket, _ in batch:
            if ticket._trace is not None and ticket._trace.sampled:
                primary = ticket
                tick_span_id = rec.alloc_id()
                break
        if primary is not None:
            engine_ctx = obs.use_context(obs.SpanContext(
                primary._trace.trace_id, tick_span_id, True))
        else:
            engine_ctx = contextlib.nullcontext()
        try:
            with self.engine_lock, engine_ctx:
                try:
                    ids = self.engine.submit(rows)
                    results = self.engine.drain()
                except BaseException:
                    # a failed tick must not leave its rows in the engine's
                    # read queue: drain() can raise before popping anything
                    # (e.g. "no model yet"), and the next tick would then
                    # drain the stale rows first, misaligning every
                    # subsequent result
                    self.engine.discard_pending()
                    raise
        except BaseException as e:
            self._worker_errors.inc()
            rec.record_event(
                "serve.worker_error",
                primary._trace if primary is not None else None, force=True,
                attrs={"error": type(e).__name__, "batch": len(batch),
                       "queue_depth": len(self._queue),
                       "tenants": sorted({t.tenant for t, _ in batch})})
            for ticket, _ in batch:
                ticket._fail(e)
                self._record_ticket_trace(
                    ticket, "error",
                    tick_span_id if ticket is primary else None,
                    batch_size=len(batch))
            return
        by_id = {r.request_id: r for r in results}
        if len(results) != len(batch) or any(rid not in by_id for rid in ids):
            self._worker_errors.inc()
            err = RuntimeError(
                f"engine returned {len(results)} results for a "
                f"{len(batch)}-row tick — its read queue was touched "
                f"outside the scheduler's engine_lock")
            rec.record_event(
                "serve.worker_error",
                primary._trace if primary is not None else None, force=True,
                attrs={"error": "ResultMisalignment", "batch": len(batch),
                       "queue_depth": len(self._queue),
                       "tenants": sorted({t.tenant for t, _ in batch})})
            for ticket, _ in batch:
                ticket._fail(err)
                self._record_ticket_trace(
                    ticket, "error",
                    tick_span_id if ticket is primary else None,
                    batch_size=len(batch))
            return
        for (ticket, _), rid in zip(batch, ids):
            ticket._resolve(by_id[rid])
            _, completed_c, lat_h = self._tenant_metrics(ticket.tenant)
            completed_c.inc()
            lat_h.observe(ticket.latency_s)
            self._record_ticket_trace(
                ticket, "ok", tick_span_id if ticket is primary else None,
                batch_size=len(batch))

    # ------------------------------------------------------------ lifecycle
    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until everything admitted so far is resolved.  Returns
        False on timeout (queue or in-flight work remains)."""
        if self._worker is None and self._autostart:
            self.start()
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._cond:
            while self._queue or self._inflight:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining if remaining is not None else 0.1)
        return True

    def close(self) -> None:
        """Stop admitting, drain what was admitted, join the worker.
        Idempotent; afterwards ``submit`` resolves everything as a
        ``shutdown`` shed."""
        with _live_lock:
            _live_schedulers.discard(self)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join()
        else:
            # never started: resolve whatever sits in the queue as shed
            with self._cond:
                while self._queue:
                    ticket, _ = self._queue.popleft()
                    self._pending[ticket.tenant] -= 1
                    ticket._resolve(ShedReject(ticket.request_id,
                                               ticket.tenant, "shutdown", 0))
                    self._count_shed(ticket.tenant, "shutdown")
                    self._record_shed(ticket, "shutdown", 0)

    def __enter__(self) -> "ServingScheduler":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
