"""The port's async serving scheduler (``repro_torch.serve``), on the
CPU: the reference's ``tests/test_serving.py`` mirrored on the port —
admission control, batching, bit-identity.  Every wait takes a timeout.

Coverage demanded by the subsystem's correctness argument (see
repro/serve/scheduler.py):
  * the bounded queue never exceeds ``queue_bound``, even under a
    many-thread submission storm;
  * a shed is a *typed result* (:class:`ShedReject` with a reason), never
    a worker exception, and the ``wait`` policy sheds nothing — it blocks
    submitters until space frees;
  * ``tenant_quota`` caps one tenant's share of the queue without
    touching other tenants' admission;
  * scores through the concurrent path are bit-identical to sequential
    ``submit``+``drain`` on the same engine (the padded static-shape
    micro-batch makes every row independent of its tick's composition);
  * a poison request fails only its own tick's tickets (re-raised at
    ``result()`` on the caller) and the worker loop survives;
  * the ``Session`` facade front door: ``score_stream`` matches
    ``score`` bitwise, the scheduler's series land in ``repro_torch.obs``,
    and
    the synchronous verbs keep working while serving is attached;
  * ``ServingSpec`` validates its knobs and round-trips through
    ``PipelineConfig`` serialization.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api.config import PipelineConfig, pipeline_config
from repro_torch.api.session import Session
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.serve import (ScoreTicket, ServingScheduler, ServingSpec,
                               ShedReject)
from repro_torch.stream import QueryResult, ServiceConfig, StreamService

torch.set_num_threads(1)


def _join(threads, timeout=120.0):
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads)


def _cluster_data(n=1200, d=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.eye(3, d) * 6.0
    x = centers[rng.integers(0, 3, n)] + rng.normal(0, 0.05, (n, d))
    return x.astype(np.float32)


def _fitted_service(d=4, micro_batch=64, seed=0):
    svc = StreamService(ServiceConfig(
        dim=d, k=3, t=20, leaf_size=512, refresh_every=10**6,
        micro_batch=micro_batch, seed=seed), device="cpu")
    svc.ingest(_cluster_data(d=d, seed=seed))
    svc.refresh()
    return svc


# ------------------------------------------------------------ spec + config
def test_spec_validates_knobs():
    assert ServingSpec().shed_policy == "shed"
    with pytest.raises(ValueError, match="queue_bound"):
        ServingSpec(queue_bound=0)
    with pytest.raises(ValueError, match="shed_policy"):
        ServingSpec(shed_policy="drop")
    with pytest.raises(ValueError, match="batch_window_ms"):
        ServingSpec(batch_window_ms=-1)
    with pytest.raises(ValueError, match="tenant_quota"):
        ServingSpec(tenant_quota=0)
    with pytest.raises(ValueError, match="cannot exceed"):
        ServingSpec(queue_bound=8, tenant_quota=9)
    # ints are accepted for the window but normalized to float (JSON round-trip)
    assert ServingSpec(batch_window_ms=3).batch_window_ms == 3.0


def test_serving_spec_roundtrips_through_pipeline_config():
    cfg = pipeline_config(
        dim=4, k=3, t=30, topology="stream", refresh_every=10**6,
        serving=ServingSpec(queue_bound=64, shed_policy="wait",
                            tenant_quota=16))
    d = cfg.to_dict()
    assert d["serving"]["queue_bound"] == 64
    assert PipelineConfig.from_dict(d) == cfg
    # dict and bare-policy-name sugar both resolve to a full spec
    assert pipeline_config(dim=4, k=3, t=30,
                           serving={"queue_bound": 8}).serving.queue_bound == 8
    assert pipeline_config(dim=4, k=3, t=30,
                           serving="wait").serving.shed_policy == "wait"
    with pytest.raises(ValueError, match="shed policy"):
        pipeline_config(dim=4, k=3, t=30, serving="nope")
    # a config without a serving section serializes without the key —
    # pre-serving artifacts keep loading and old byte-level dumps hold
    assert "serving" not in pipeline_config(dim=4, k=3, t=30).to_dict()


# ------------------------------------------------------------ admission
def test_bounded_queue_never_exceeds_cap_under_thread_storm():
    """12 threads hammer a stopped scheduler: the queue's high-water mark
    must respect ``queue_bound`` and the excess must come back as typed
    sheds — then, once the worker starts, everything admitted completes."""
    svc = _fitted_service()
    spec = ServingSpec(queue_bound=50, batch_window_ms=0.0)
    sched = ServingScheduler(svc, spec, autostart=False)
    x = _cluster_data(n=400, seed=1)
    all_tickets = []
    lock = threading.Lock()

    def storm(i):
        rows = x[i * 30:(i + 1) * 30]
        got = sched.submit(rows, tenant=f"t{i % 3}")
        with lock:
            all_tickets.extend(got)

    threads = [threading.Thread(target=storm, args=(i,)) for i in range(12)]
    for th in threads:
        th.start()
    _join(threads)
    assert sched.peak_depth <= spec.queue_bound
    assert sched.queue_depth == spec.queue_bound  # storm >> bound: full
    shed = [t for t in all_tickets if t.shed]
    assert len(shed) == len(all_tickets) - spec.queue_bound
    assert all(t.result().reason == "queue_full" for t in shed)
    sched.start()
    assert sched.flush(timeout=60.0)
    for t in all_tickets:
        res = t.result(timeout=10.0)
        assert isinstance(res, (QueryResult, ShedReject))
    sched.close()


def test_shed_is_a_typed_result_not_an_exception():
    svc = _fitted_service()
    sched = ServingScheduler(svc, ServingSpec(queue_bound=4),
                             autostart=False)
    x = _cluster_data(n=10, seed=2)
    tickets = sched.submit(x)
    admitted = [t for t in tickets if not t.shed]
    rejected = [t for t in tickets if t.shed]
    assert len(admitted) == 4 and len(rejected) == 6
    for t in rejected:
        r = t.result()              # returns, never raises
        assert isinstance(r, ShedReject)
        assert r.reason == "queue_full" and r.tenant == "default"
        assert t.done() and t.latency_s is not None
    sched.close()
    # after close every admitted-but-unscored request resolves as shutdown
    for t in admitted:
        r = t.result(timeout=1.0)
        assert isinstance(r, ShedReject) and r.reason == "shutdown"
    # and new submissions shed immediately as shutdown
    post = sched.submit(x[:1])
    assert post[0].result().reason == "shutdown"


def test_wait_policy_blocks_submitters_and_sheds_nothing():
    svc = _fitted_service(micro_batch=32)
    sched = ServingScheduler(
        svc, ServingSpec(queue_bound=16, shed_policy="wait",
                         batch_window_ms=0.5))
    x = _cluster_data(n=600, seed=3)
    results_per_thread = {}

    def client(ci):
        tickets = sched.submit(x[ci * 150:(ci + 1) * 150])
        results_per_thread[ci] = [t.result(timeout=60.0) for t in tickets]

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
    for th in threads:
        th.start()
    _join(threads)
    assert sched.peak_depth <= 16
    all_res = [r for rs in results_per_thread.values() for r in rs]
    assert len(all_res) == 600
    assert all(isinstance(r, QueryResult) for r in all_res)  # zero sheds
    sched.close()


def test_tenant_quota_caps_one_tenant_not_the_others():
    svc = _fitted_service()
    sched = ServingScheduler(
        svc, ServingSpec(queue_bound=64, tenant_quota=8), autostart=False)
    x = _cluster_data(n=40, seed=4)
    noisy = sched.submit(x[:20], tenant="noisy")
    assert sum(not t.shed for t in noisy) == 8
    assert all(t.result().reason == "tenant_quota"
               for t in noisy if t.shed)
    # the quota bound the noisy tenant, not the queue: quiet still enters
    quiet = sched.submit(x[20:28], tenant="quiet")
    assert all(not t.shed for t in quiet)
    sched.close()


# ------------------------------------------------------------ bit identity
def test_concurrent_scores_bit_identical_to_sequential():
    """The acceptance criterion: rows scored through the concurrent
    scheduler (interleaved across threads, arbitrary tick composition)
    equal sequential submit+drain on the same engine, bitwise."""
    svc = _fitted_service(micro_batch=32)
    x = _cluster_data(n=320, seed=5)
    sequential = []
    for i in range(0, len(x), 32):
        svc.submit(x[i:i + 32])
        sequential.extend(svc.drain())

    sched = ServingScheduler(svc, ServingSpec(queue_bound=4096,
                                              batch_window_ms=1.0))
    slots = [None] * 8

    def client(ci):
        rows = x[ci * 40:(ci + 1) * 40]
        slots[ci] = [t.result(timeout=60.0) for t in sched.submit(rows)]

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(8)]
    for th in threads:
        th.start()
    _join(threads)
    sched.close()
    concurrent = [r for rs in slots for r in rs]
    assert len(concurrent) == len(sequential) == 320
    for a, b in zip(sequential, concurrent):
        assert a.center == b.center
        assert a.distance == b.distance            # bitwise, not approx
        assert a.outlier_score == b.outlier_score
        assert a.is_outlier == b.is_outlier


def test_fused_score_bit_identical_to_composed():
    """The read path scores each micro-batch through ONE fused kernel
    dispatch (``repro_torch.kernels.score``); for the non-quantized
    backends it must return bitwise what the composed min_argmin + divide
    would — fusing the serving hot path is a pure perf change, never a
    numerics change."""

    def composed_batch(xb, centers, threshold, *, metric, policy):
        dist, amin = min_argmin(xb, centers, metric=metric, policy=policy)
        return dist, amin, dist / torch.clamp(threshold, min=1e-30)

    cfg = pipeline_config(
        dim=4, k=3, t=30, topology="stream", leaf_size=512,
        refresh_every=10**6, micro_batch=64,
        serving={"queue_bound": 256, "batch_window_ms": 1.0}, seed=0)
    x = _cluster_data(n=100, seed=12)       # ragged last micro-batch
    with Session(cfg, device="cpu") as session:
        session.fit(_cluster_data(n=900, seed=12))
        model = session.model
        svc_cfg = session.engine.cfg
        fused = list(session.score_stream(x, timeout=60.0))
    assert len(fused) == len(x)
    mb, j = svc_cfg.micro_batch, 0
    for i in range(0, len(x), mb):
        chunk = x[i:i + mb]
        xb = np.zeros((mb, svc_cfg.dim), np.float32)
        xb[:len(chunk)] = chunk
        dist, amin, score = composed_batch(
            torch.from_numpy(xb), model.centers, model.threshold,
            metric=svc_cfg.metric, policy=svc_cfg.policy)
        dist, amin, score = (a.numpy() for a in (dist, amin, score))
        for r in range(len(chunk)):
            got = fused[j]
            assert got.center == int(amin[r])
            assert got.distance == float(dist[r])         # bitwise
            assert got.outlier_score == float(score[r])   # bitwise
            assert got.is_outlier == bool(score[r] > 1.0)
            j += 1


# ------------------------------------------------------------ worker errors
def test_worker_error_reraised_on_caller_and_loop_survives():
    """Scoring before any model exists fails inside the worker tick; the
    error must surface at ``result()`` on the caller's thread, the failed
    tick must leave no stale rows in the engine's read queue, and the
    worker must stay alive to serve the next (valid) tick correctly."""
    svc = StreamService(ServiceConfig(
        dim=4, k=3, t=20, leaf_size=512, refresh_every=10**6,
        micro_batch=64, seed=0), device="cpu")
    sched = ServingScheduler(svc, ServingSpec(batch_window_ms=0.0))
    x = _cluster_data(n=8, seed=6)
    bad = sched.submit(x)
    with pytest.raises(RuntimeError):
        bad[0].result(timeout=30.0)
    assert all(t.done() for t in bad)      # the whole tick failed together
    assert len(svc._queue) == 0            # ...and left no stale rows behind
    # heal the engine; the same scheduler/worker must now serve fine —
    # with *different* rows than the failed tick, so leftover stale rows
    # would surface as wrong scores rather than coincidentally-equal ones
    svc.ingest(_cluster_data(seed=0))
    svc.refresh()
    y = _cluster_data(n=8, seed=9)
    good = sched.submit(y)
    results = [t.result(timeout=30.0) for t in good]
    assert all(isinstance(r, QueryResult) for r in results)
    sched.close()
    # post-close direct scoring of the same rows is the reference
    for a, b in zip(svc.score(y), results):
        assert (a.center, a.distance, a.outlier_score) \
            == (b.center, b.distance, b.outlier_score)

    # validation errors raise at submit() on the caller, pre-admission
    svc2 = _fitted_service()
    with ServingScheduler(svc2) as s2:
        with pytest.raises(ValueError):
            s2.submit(np.zeros((4, 9), np.float32))   # wrong dim


def test_queue_depth_gauge_sums_live_schedulers_only():
    """serve.queue_depth is one process-global series, but schedulers come
    and go with Sessions: the gauge must read the sum over *live*
    schedulers, not whichever instance registered its callback last, and a
    closed scheduler must leave the sum."""
    svc = _fitted_service()
    s1 = ServingScheduler(svc, ServingSpec(queue_bound=50), autostart=False)
    s2 = ServingScheduler(svc, ServingSpec(queue_bound=50), autostart=False)
    x = _cluster_data(n=10, seed=11)
    s1.submit(x[:4])
    s2.submit(x[4:])
    g = obs.gauge("serve.queue_depth")
    assert g.get() == 10                 # both live schedulers counted
    s2.close()
    assert g.get() == 4                  # s2 gone; s1's depth still reported
    s1.close()
    assert g.get() == 0


# ------------------------------------------------------------ session facade
def test_session_score_stream_matches_score_and_emits_metrics():
    cfg = pipeline_config(
        dim=4, k=3, t=30, topology="stream", leaf_size=512,
        refresh_every=10**6, micro_batch=64,
        serving={"queue_bound": 256, "batch_window_ms": 1.0}, seed=0)
    x = _cluster_data(n=900, seed=7)
    with Session(cfg, device="cpu") as session:
        session.fit(x)
        sync = session.score(x[:100])
        conc = list(session.score_stream(x[:100], timeout=60.0))
        assert len(conc) == 100
        for a, b in zip(sync, conc):
            assert (a.center, a.distance, a.outlier_score) \
                == (b.center, b.distance, b.outlier_score)
        # the scheduler came from the config's serving section
        assert session.serving.spec.queue_bound == 256
        # synchronous verbs still work while serving is attached (they
        # route through the scheduler's engine lock)
        session.ingest(x[:64])
        assert len(session.score(x[:8])) == 8
        tickets = session.submit_stream(x[:16], tenant="acme")
        assert all(isinstance(t, ScoreTicket) for t in tickets)
        assert all(isinstance(t.result(timeout=60.0), QueryResult)
                   for t in tickets)
        snap = obs.snapshot()
    keys = [k for sec in ("counters", "gauges", "histograms")
            for k in snap.get(sec, {})]
    for want in ("serve.queue_depth", "serve.ticks",
                 "serve.batch_occupancy",
                 "serve.admitted{tenant=acme}",
                 "serve.completed{tenant=default}",
                 "serve.latency{tenant=default,topology=scheduler}"):
        assert any(k == want or k.startswith(want) for k in keys), want
    # the context manager closed serving; the session still scores
    assert session.serving is None
    assert len(session.score(x[:4])) == 4
    session.close()                                  # idempotent


def test_session_serve_attach_is_thread_safe():
    """Concurrent first ``serve()`` calls must attach exactly one
    scheduler — two would race their worker ticks on the shared engine."""
    cfg = pipeline_config(
        dim=4, k=3, t=30, topology="stream", leaf_size=512,
        refresh_every=10**6, micro_batch=64, seed=0)
    with Session(cfg, device="cpu") as session:
        session.fit(_cluster_data(seed=0))
        n = 8
        barrier = threading.Barrier(n)
        got = [None] * n

        def attach(i):
            barrier.wait()
            got[i] = session.serve()

        threads = [threading.Thread(target=attach, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        _join(threads)
        assert all(s is got[0] for s in got)
        assert session.serving is got[0]


# ------------------------------------------------------------ fairness
def test_tenant_fairness_under_storm_with_quota():
    """One tenant bursting past its quota, one staying small, quota = half
    the queue: the noisy tenant alone absorbs every shed (all typed
    ``tenant_quota``) and the quiet tenant completes everything — it can
    never be crowded out, because noisy's queue share is capped at 32 and
    quiet's worst-case demand (2 threads x 8 rows) always fits in the
    remaining 32."""
    svc = _fitted_service(micro_batch=32)
    sched = ServingScheduler(
        svc, ServingSpec(queue_bound=64, tenant_quota=32,
                         batch_window_ms=0.5))
    x = _cluster_data(n=4000, seed=8)
    done = {"noisy": 0, "quiet": 0}
    shed_reasons = []
    lock = threading.Lock()

    def client(tenant, rows, burst):
        finished, reasons = 0, []
        for i in range(0, len(rows), burst):
            for t in sched.submit(rows[i:i + burst], tenant=tenant):
                r = t.result(timeout=60.0)
                if isinstance(r, ShedReject):
                    reasons.append((r.tenant, r.reason))
                else:
                    finished += 1
        with lock:
            done[tenant] += finished
            shed_reasons.extend(reasons)

    threads = ([threading.Thread(target=client,
                                 args=("noisy", x[:1600], 40))
                for _ in range(2)]
               + [threading.Thread(target=client,
                                   args=("quiet", x[:400], 8))
                  for _ in range(2)])
    for th in threads:
        th.start()
    _join(threads)
    sched.close()
    # the quiet tenant is never starved: every one of its rows completed
    assert done["quiet"] == 800
    # every shed hit the noisy tenant, and via its quota — never the
    # shared queue bound (noisy<=32 + quiet<=16 can't fill 64)
    assert all(t == "noisy" and r == "tenant_quota"
               for t, r in shed_reasons), shed_reasons[:5]
    assert done["noisy"] + len(shed_reasons) == 3200


# ------------------------------------------------------------ stress
def test_stress_many_clients_with_async_refresh_in_flight():
    """More client threads than cores under a 1 us switch interval, while
    the session ingests and an async refresh runs on the engine: every row
    resolves to a result, and the scheduler's tallies (admitted,
    completed, latency samples) lose no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.using_registry(obs.MetricsRegistry()) as reg:
            cfg = pipeline_config(
                dim=4, k=3, t=20, topology="stream", leaf_size=256,
                refresh_every=10**6, micro_batch=32, async_refresh=True,
                serving={"queue_bound": 4096, "batch_window_ms": 0.5},
                seed=0)
            sess = Session(cfg, device="cpu")
            sess.fit(_cluster_data(seed=0))
            v0 = int(sess.model.version)
            n_clients, per = min(4 * (os.cpu_count() or 1), 32), 24
            rows = _cluster_data(n=n_clients * per, seed=13)
            out = [None] * n_clients

            def client(i):
                out[i] = list(sess.score_stream(
                    rows[i * per:(i + 1) * per], tenant=f"t{i % 4}",
                    timeout=120.0))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for th in threads:
                th.start()
            sess.ingest(_cluster_data(n=300, seed=14))
            sess.refresh(blocking=False)      # in flight while clients score
            _join(threads)
            sess.refresh()                    # joins it, then refits
            sess.close()
            snap = reg.snapshot()
    finally:
        sys.setswitchinterval(old)
    results = [r for rs in out for r in rs]
    assert len(results) == len(rows)
    assert all(isinstance(r, QueryResult) for r in results)
    c = snap["counters"]
    for name in ("serve.admitted{", "serve.completed{"):
        assert sum(v for k, v in c.items() if k.startswith(name)) == \
            len(rows), name
    assert sum(h["count"] for k, h in snap["histograms"].items()
               if k.startswith("serve.latency{tenant=")) == len(rows)
    assert int(sess.model.version) == v0 + 2
    assert len(sess.engine._queue) == 0
