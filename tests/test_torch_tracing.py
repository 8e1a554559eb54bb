"""The port's request-level tracing and online monitors (the flight
recorder, ``repro_torch.obs``), on the CPU: the reference's
``tests/test_tracing.py`` mirrored on the port.  The exports are checked
with the reference's stdlib validators (``benchmarks/check_trace.py``,
``benchmarks/check_obs_snapshot.py``), unchanged.

Coverage demanded by the observability PR's acceptance criteria:
  * a concurrent ``score_stream`` storm yields exactly ONE trace per
    ticket, with admission / queue-wait / tick spans parented under the
    ``serve.request`` root — the cross-thread stitch works;
  * head sampling is deterministic under a seeded sampler and is decided
    once at the trace root;
  * ``sample_rate=0`` records nothing except forced events — shed
    rejections (with the rejecting tenant and live queue depth) and
    worker-tick errors survive any sampling rate;
  * scores are bit-identical with tracing on or off;
  * a sharded refresh stitches its per-site root summaries under one
    refresh trace;
  * the Chrome trace-event export is valid per ``benchmarks/
    check_trace.py`` (well-formed, monotone ts, every parent exists);
  * the paper-grounded outlier-rate monitor raises an ``Alert`` on a
    drifting stream, and the staleness / shed-burn monitors fire on
    their thresholds;
  * ``snapshot()`` schema v2 round-trips the validator, and v1
    snapshots are still accepted via the downgrade path.

Tests isolate with ``obs.using_registry`` — which isolates the flight
recorder and monitor hub exactly like metric state — and construct
services *inside* the scope because layers capture handles at
construction.
"""
from __future__ import annotations

import importlib.util
import json
import random
import threading
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch import obs
from repro_torch.api.config import PipelineConfig, pipeline_config
from repro_torch.api.session import Session
from repro_torch.obs.monitors import (MonitorHub, ShedRateMonitor,
                                      StalenessMonitor)
from repro_torch.obs.tracing import FlightRecorder, TraceSpec
from repro_torch.serve import ServingScheduler, ServingSpec
from repro_torch.stream import QueryResult, ServiceConfig, StreamService
from repro_torch.stream.sharded import (ShardedServiceConfig,
                                        ShardedStreamService)

torch.set_num_threads(1)

_BENCH = Path(__file__).resolve().parent.parent / "benchmarks"


def _load_bench(name: str):
    spec = importlib.util.spec_from_file_location(name, _BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


# ------------------------------------------------------------ recorder core
def test_root_trace_and_nested_spans_parent_correctly():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        rec = reg.recorder
        with obs.root_trace("req", kind="unit") as ctx:
            assert obs.current_context() == ctx
            with obs.trace("step.inner", site=0):
                pass
        root = rec.spans("req")
        inner = rec.spans("step.inner")
        assert len(root) == 1 and len(inner) == 1
        assert root[0]["span_id"] == ctx.span_id
        assert root[0]["parent_id"] is None
        assert root[0]["attrs"] == {"kind": "unit"}
        assert inner[0]["trace_id"] == ctx.trace_id
        assert inner[0]["parent_id"] == ctx.span_id
        # the dual span still fed the phase histogram
        assert reg.snapshot()["histograms"][
            "phase.step.inner{site=0}"]["count"] == 1
        # outside any trace, obs.trace degrades to histogram-only
        assert obs.current_context() is None


def test_disabled_recorder_is_inert_and_ring_bounds_memory():
    rec = FlightRecorder(False)
    assert rec.new_trace() is None
    assert rec.record_event("x", force=True) is False
    rec = FlightRecorder(True, ring=4)
    ctx = rec.new_trace()
    for i in range(10):
        rec.record_span(f"s{i}", ctx, t0=float(i), t1=float(i) + 0.5,
                        parent_id=None)
    section = rec.snapshot_section()
    assert section["buffered"] == 4
    assert section["recorded"] == 10
    assert section["dropped"] == 6


def test_export_filters_spans_whose_parent_left_the_ring():
    rec = FlightRecorder(True, ring=3)
    ctx = rec.new_trace()
    root_id = rec.record_span("root", ctx, t0=0.0, t1=10.0,
                              span_id=ctx.span_id, parent_id=None)
    for i in range(4):   # evicts the root from the 3-slot ring
        rec.record_span(f"child{i}", ctx, t0=1.0 + i, t1=2.0 + i,
                        parent_id=root_id)
    doc = rec.export_chrome()
    assert doc["traceEvents"] == []   # children are orphans: all filtered
    assert doc["otherData"]["orphaned_spans"] == 3
    check_trace = _load_bench("check_trace")
    # an export with surviving parentage is validator-clean
    rec2 = FlightRecorder(True)
    ctx2 = rec2.new_trace()
    rid = rec2.record_span("root", ctx2, t0=0.0, t1=10.0,
                           span_id=ctx2.span_id, parent_id=None)
    rec2.record_span("child", ctx2, t0=1.0, t1=2.0, parent_id=rid)
    assert check_trace.validate_trace(rec2.export_chrome()) == []


def test_seeded_sampler_is_deterministic():
    rec_a = FlightRecorder(True, sample_rate=0.5, seed=123)
    rec_b = FlightRecorder(True, sample_rate=0.5, seed=123)
    a = [rec_a.new_trace().sampled for _ in range(200)]
    b = [rec_b.new_trace().sampled for _ in range(200)]
    assert a == b
    # the sampled set is a pure replay of random.Random(seed)
    replay = random.Random(123)
    assert a == [replay.random() < 0.5 for _ in range(200)]
    assert 0 < sum(a) < 200   # actually mixed at 0.5
    # rates 0 and 1 never consult the rng (decision order independent)
    rec1 = FlightRecorder(True, sample_rate=1.0, seed=123)
    rec0 = FlightRecorder(True, sample_rate=0.0, seed=123)
    assert all(rec1.new_trace().sampled for _ in range(10))
    assert not any(rec0.new_trace().sampled for _ in range(10))


def test_trace_spec_validates_and_roundtrips_through_config():
    with pytest.raises(ValueError, match="sample_rate"):
        TraceSpec(sample_rate=1.5)
    with pytest.raises(ValueError, match="ring"):
        TraceSpec(ring=0)
    cfg = pipeline_config(dim=4, k=3, t=30, topology="stream",
                          refresh_every=10**6,
                          tracing=TraceSpec(sample_rate=0.25, seed=7))
    d = cfg.to_dict()
    assert d["tracing"]["sample_rate"] == 0.25
    assert PipelineConfig.from_dict(d) == cfg
    # sugar: bool toggles, float sets the rate
    assert pipeline_config(dim=4, k=3, t=30, tracing=False) \
        .tracing.enabled is False
    assert pipeline_config(dim=4, k=3, t=30, tracing=0.5) \
        .tracing.sample_rate == 0.5
    # no tracing section -> key absent (old artifacts keep loading)
    assert "tracing" not in pipeline_config(dim=4, k=3, t=30).to_dict()


# ------------------------------------------------------------ serve stitch
def test_score_stream_storm_yields_one_stitched_trace_per_ticket(tmp_path):
    n_threads, per_thread = 8, 16
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        sess = Session(pipeline_config(
            dim=4, k=3, t=20, topology="stream", refresh_every=10**6,
            serving={"queue_bound": 256, "shed_policy": "wait"}),
            device="cpu")
        sess.fit(_cluster_data())
        x = _cluster_data(n=n_threads * per_thread, seed=2)
        results = [None] * n_threads

        def client(i):
            rows = x[i * per_thread:(i + 1) * per_thread]
            results[i] = list(sess.score_stream(rows, tenant=f"t{i}",
                                                timeout=60.0))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads)
        sess.close()
        assert all(isinstance(r, QueryResult)
                   for got in results for r in got)

        rec = reg.recorder
        reqs = rec.spans("serve.request")
        # exactly one trace per submitted row, each rooted at its request
        assert len(reqs) == n_threads * per_thread
        assert len({s["trace_id"] for s in reqs}) == len(reqs)
        assert len({s["attrs"]["request_id"] for s in reqs}) == len(reqs)
        by_trace = {s["trace_id"]: s for s in reqs}
        for name in ("serve.admission", "serve.queue_wait", "serve.tick"):
            spans = rec.spans(name)
            assert len(spans) == len(reqs), name
            for s in spans:
                root = by_trace[s["trace_id"]]
                assert s["parent_id"] == root["span_id"]
                assert root["t0"] <= s["t0"] <= s["t1"] <= root["t1"]
        # each tick's primary trace absorbed the engine-side spans
        fused = rec.spans("score.fused")
        assert fused and all(f["trace_id"] in by_trace for f in fused)

        # the export is a valid Chrome trace per the CI validator
        check_trace = _load_bench("check_trace")
        doc = rec.export_chrome()
        assert check_trace.validate_trace(doc) == []
        assert check_trace.check_required(
            doc, ["serve.request", "serve.queue_wait", "serve.tick",
                  "score.fused"]) == []
        # and Session.dump_trace writes the same thing, loadable from disk
        out = tmp_path / "trace.json"
        sess.dump_trace(out)
        assert check_trace.validate_trace(
            json.loads(out.read_text())) == []
        jl = tmp_path / "trace.jsonl"
        sess.dump_trace(jl, fmt="jsonl")
        lines = [json.loads(line) for line in
                 jl.read_text().splitlines()]
        assert lines and all("ts" in r and "dur_s" in r for r in lines
                             if r["kind"] == "span")


def test_sample_rate_zero_records_only_forced_shed_events():
    rec = FlightRecorder(True, sample_rate=0.0)
    with obs.using_registry(obs.MetricsRegistry(recorder=rec)):
        svc = _fitted_service()
        spec = ServingSpec(queue_bound=8, batch_window_ms=0.0)
        sched = ServingScheduler(svc, spec, autostart=False)
        tickets = sched.submit(_cluster_data(n=20, seed=3), tenant="noisy")
        shed = [t for t in tickets if t.shed]
        assert len(shed) == 12
        events = rec.events("serve.shed")
        assert len(events) == 12
        for ev in events:
            assert ev["attrs"]["tenant"] == "noisy"
            assert ev["attrs"]["queue_depth"] >= spec.queue_bound
            assert "request_id" in ev["attrs"]
        # shed lifecycles force-record their request root too...
        shed_reqs = rec.spans("serve.request")
        assert len(shed_reqs) == 12
        assert all(s["status"] == "shed" for s in shed_reqs)
        sched.start()
        assert sched.flush(timeout=60.0)
        sched.close()
        # ...but successfully served, unsampled requests record nothing
        assert len(rec.spans("serve.request")) == 12
        assert rec.spans("serve.tick") == []
        assert rec.spans("score.fused") == []


def test_worker_error_is_force_recorded_with_context():
    rec = FlightRecorder(True, sample_rate=0.0)   # force paths only
    with obs.using_registry(obs.MetricsRegistry(recorder=rec)):
        svc = _fitted_service()
        sched = ServingScheduler(
            svc, ServingSpec(queue_bound=64, batch_window_ms=0.0),
            autostart=False)
        tickets = sched.submit(_cluster_data(n=4, seed=4), tenant="t0")

        def boom(rows):
            raise RuntimeError("poisoned tick")
        svc.submit = boom
        sched.start()
        for t in tickets:
            with pytest.raises(RuntimeError, match="poisoned tick"):
                t.result(timeout=30.0)
        sched.close()
        events = rec.events("serve.worker_error")
        assert len(events) >= 1
        assert events[0]["attrs"]["error"] == "RuntimeError"
        assert events[0]["attrs"]["tenants"] == ["t0"]
        errs = [s for s in rec.spans("serve.request")
                if s["status"] == "error"]
        assert len(errs) == len(tickets)


def test_scores_bit_identical_with_tracing_on_and_off():
    q = _cluster_data(n=256, seed=5)
    with obs.using_registry(obs.MetricsRegistry()):
        svc = _fitted_service()
        assert obs.tracing_enabled()
        a = svc.score(q)
        obs.set_tracing_enabled(False)
        b = svc.score(q)
        obs.set_tracing_enabled(True)
        c = svc.score(q)
    for other in (b, c):
        assert [r.outlier_score for r in a] == \
            [r.outlier_score for r in other]
        assert [(r.center, r.distance, r.is_outlier) for r in a] == \
            [(r.center, r.distance, r.is_outlier) for r in other]


# ------------------------------------------------------------ refresh stitch
def test_sharded_refresh_stitches_site_roots_under_one_trace():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        cfg = ShardedServiceConfig(
            dim=4, k=3, t=8, n_sites=3, leaf_size=64, refresh_every=10**6,
            micro_batch=32, second_iters=5, seed=0)
        svc = ShardedStreamService(cfg, device="cpu")
        svc.ingest(_cluster_data(n=600, seed=6))
        svc.refresh()
        rec = reg.recorder
        roots = rec.spans("refresh")
        assert len(roots) == 1
        tid = roots[0]["trace_id"]
        sites = rec.spans("refresh.site_root")
        assert len(sites) == cfg.n_sites
        assert {s["attrs"]["site"] for s in sites} == set(range(cfg.n_sites))
        assert all(s["trace_id"] == tid for s in sites)
        for name in ("refresh.gather", "refresh.fit", "refresh.install"):
            got = rec.spans(name)
            assert got and all(s["trace_id"] == tid for s in got), name
        check_trace = _load_bench("check_trace")
        assert check_trace.validate_trace(rec.export_chrome()) == []


def test_async_refresh_carries_trace_across_fit_worker():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        svc = _fitted_service()
        svc.ingest(_cluster_data(n=400, seed=7))
        before = len(reg.recorder.spans("refresh"))
        svc.refresh(blocking=False)
        svc.join_refresh()
        roots = reg.recorder.spans("refresh")
        assert len(roots) == before + 1
        tid = roots[-1]["trace_id"]
        fits = [s for s in reg.recorder.spans("refresh.fit")
                if s["trace_id"] == tid]
        installs = [s for s in reg.recorder.spans("refresh.install")
                    if s["trace_id"] == tid]
        assert fits and installs   # worker thread + poller both stitched


# ------------------------------------------------------------ monitors
def test_outlier_rate_monitor_alerts_on_drifting_stream():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        svc = _fitted_service()
        # healthy traffic: no drift alert
        svc.score(_cluster_data(n=128, seed=8))
        names = [a["name"] for a in reg.snapshot()["alerts"]]
        assert "outlier_rate_high" not in names
        # drifted traffic: every query lands far from every center
        far = np.full((128, 4), 100.0, np.float32) \
            + np.random.default_rng(9).normal(0, 0.1, (128, 4)).astype(
                np.float32)
        svc.score(far)
        alerts = reg.snapshot()["alerts"]
        drift = [a for a in alerts if a["name"] == "outlier_rate_high"]
        assert len(drift) == 1
        assert drift[0]["severity"] == "warn"
        assert drift[0]["labels"] == {"topology": "stream"}
        assert drift[0]["value"] > drift[0]["threshold"]


def test_staleness_monitor_fires_past_slo():
    mon = StalenessMonitor(slo_s=0.5)
    assert mon.evaluate(()) == []          # no source wired yet
    mon.set_source(lambda: 0.2)
    assert mon.evaluate(()) == []          # fresh
    mon.set_source(lambda: 3.0)
    (alert,) = mon.evaluate((("topology", "stream"),))
    assert alert.name == "model_staleness"
    assert alert.value == 3.0 and alert.threshold == 0.5
    mon.set_source(lambda: (_ for _ in ()).throw(RuntimeError()))
    assert mon.evaluate(()) == []          # a broken source never pages


def test_shed_rate_monitor_closed_form_matches_per_event():
    batched = ShedRateMonitor(alpha=0.05, burn_max=0.1, min_events=1)
    stepwise = ShedRateMonitor(alpha=0.05, burn_max=0.1, min_events=1)
    batched.observe(3, 2)
    for _ in range(3):
        stepwise.observe(1, 0)
    for _ in range(2):
        stepwise.observe(0, 1)
    assert batched._ewma == pytest.approx(stepwise._ewma, rel=1e-12)
    burning = ShedRateMonitor(alpha=0.05, burn_max=0.1, min_events=4)
    burning.observe(0, 50)
    (alert,) = burning.evaluate(())
    assert alert.name == "shed_burn" and alert.value > 0.9


def test_scheduler_feeds_shed_burn_monitor():
    hub = MonitorHub(shed_min_events=4, shed_burn_max=0.1, shed_alpha=0.3)
    with obs.using_registry(obs.MetricsRegistry(monitors=hub)) as reg:
        svc = _fitted_service()
        sched = ServingScheduler(
            svc, ServingSpec(queue_bound=4, batch_window_ms=0.0),
            autostart=False)
        sched.submit(_cluster_data(n=40, seed=10))   # 4 admitted, 36 shed
        sched.start()
        sched.flush(timeout=60.0)
        sched.close()
        burn = [a for a in reg.snapshot()["alerts"]
                if a["name"] == "shed_burn"]
        assert len(burn) == 1


# ------------------------------------------------------------ snapshot schema
def test_snapshot_v2_passes_validator_and_v1_still_accepted():
    checker = _load_bench("check_obs_snapshot")
    schema = json.loads((_BENCH / "obs_schema.json").read_text())
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        reg.counter("c").inc()
        with obs.root_trace("r"):
            pass
        snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["version"] == 2
    assert checker.validate(snap, schema) == []
    assert checker.semantic_checks(snap) == []
    # a malformed alert entry is caught by the items walker
    bad = dict(snap)
    bad["alerts"] = [{"name": "x"}]
    assert any("alerts[0]" in e for e in checker.validate(bad, schema))
    # legacy v1 snapshot: rejected by v2 schema, accepted after downgrade
    v1 = {k: v for k, v in snap.items() if k not in ("alerts", "trace")}
    v1["version"] = 1
    assert checker.validate(v1, schema) != []
    assert checker.validate(v1, checker.downgrade_schema_to_v1(schema)) == []
