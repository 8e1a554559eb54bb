"""The port's telemetry plane (``repro_torch.obs``), on the CPU: the
reference's ``tests/test_obs.py`` mirrored on the port (registry
semantics, layer instrumentation, front-door snapshot coverage, the
bit-identity guarantee), then parity with the reference's plane.

Most tests isolate themselves with ``obs.using_registry`` so process-wide
series from other tests don't leak in; the layer tests construct their
services *inside* the scope because instrumented layers capture metric
handles at construction.

Parity: the same integer-grid stream (``test_torch_stream.grid``) through
the reference's service and the port's, under the replay sampler (key
``jax.random.key(7)``), each under its own fresh registry, gives
snapshots with the same metric keys and the same tree, store, refresh,
comm and checkpoint counter values, and flight-recorder traces with the
same span names and the same parent links.
"""
from __future__ import annotations

import json
import threading
from collections import Counter as Tally

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.stream as J
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.distributed import simulate_coordinator as j_simulate
from repro.store import StoreSpec as JStoreSpec
from repro_torch import obs
from repro_torch.api.config import pipeline_config
from repro_torch.api.session import Session
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.distributed import simulate_coordinator
from repro_torch.data.synthetic import gauss
from repro_torch.obs.registry import metric_key, split_key
from repro_torch.store import StoreSpec
from repro_torch.stream.service import ServiceConfig, StreamService
from repro_torch.stream.sharded import (ShardedServiceConfig,
                                        ShardedStreamService)
from test_torch_replay import JaxReplaySampler
from test_torch_stream import grid

torch.set_num_threads(1)


# --------------------------------------------------------------- registry
def test_histogram_percentiles_match_numpy():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat")
    rng = np.random.default_rng(0)
    xs = rng.exponential(scale=0.01, size=1500)
    for v in xs:
        h.observe(v)
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    e = h.snapshot_entry()
    assert e["p50"] == pytest.approx(float(np.percentile(xs, 50)))
    assert e["p95"] == pytest.approx(float(np.percentile(xs, 95)))
    assert e["p99"] == pytest.approx(float(np.percentile(xs, 99)))
    assert e["count"] == 1500
    assert e["min"] == pytest.approx(xs.min())
    assert e["max"] == pytest.approx(xs.max())


def test_histogram_ring_bounds_memory_but_buckets_stay_cumulative():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat", ring=100)
    for v in np.linspace(0.001, 0.002, 1000):
        h.observe(v)
    e = h.snapshot_entry()
    assert e["count"] == 1000                    # buckets: full history
    assert e["buckets"]["+Inf"] == 1000
    assert len(h._ring) == 100                   # ring: bounded
    # percentiles computed over the *recent* 100 samples
    recent = np.linspace(0.001, 0.002, 1000)[-100:]
    assert h.percentile(50) == pytest.approx(float(np.percentile(recent, 50)))


def test_histogram_bucket_le_semantics():
    reg = obs.MetricsRegistry()
    h = reg.histogram("x", buckets=(1.0, 2.0))
    for v in (0.5, 1.0, 1.5, 2.0, 99.0):
        h.observe(v)
    b = h.snapshot_entry()["buckets"]
    assert b["1"] == 2        # 0.5, 1.0  (le-inclusive)
    assert b["2"] == 4        # + 1.5, 2.0
    assert b["+Inf"] == 5


def test_snapshot_golden_schema():
    """The snapshot dict is a cross-PR surface — shape pinned here."""
    reg = obs.MetricsRegistry()
    reg.counter("c", a="1").inc(3)
    reg.gauge("g").set(2.5)
    reg.histogram("h", buckets=(0.1,)).observe(0.05)
    snap = reg.snapshot()
    assert snap == {
        "version": 2,
        "enabled": True,
        "counters": {"c{a=1}": 3},
        "gauges": {"g": 2.5},
        "histograms": {"h": {
            "count": 1, "sum": 0.05, "min": 0.05, "max": 0.05,
            "p50": 0.05, "p95": 0.05, "p99": pytest.approx(0.05),
            "buckets": {"0.1": 1, "+Inf": 1},
        }},
        "alerts": [],
        "trace": {
            "enabled": True, "sample_rate": 1.0, "ring": 65536,
            "recorded": 0, "buffered": 0, "dropped": 0, "traces": 0,
        },
    }
    json.dumps(snap)   # JSON-serializable as-is


def test_counter_thread_safety():
    reg = obs.MetricsRegistry()
    c = reg.counter("hits")
    n_threads, per = 8, 5000

    def work():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per


def test_histogram_thread_safety():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat")
    n_threads, per = 4, 2000

    def work():
        for _ in range(per):
            h.observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    e = h.snapshot_entry()
    assert e["count"] == n_threads * per
    assert e["buckets"]["+Inf"] == n_threads * per


def test_disabled_registry_is_noop():
    reg = obs.MetricsRegistry(enabled=False)
    reg.counter("c").inc()
    reg.gauge("g").set(1.0)
    reg.histogram("h").observe(1.0)
    with reg.trace("p"):
        pass
    snap = reg.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"]["c"] == 0
    assert snap["histograms"]["h"]["count"] == 0
    assert "phase.p" not in snap["histograms"]


def test_gauge_callable_and_failure():
    reg = obs.MetricsRegistry()
    reg.gauge("ok").set_fn(lambda: 42)
    reg.gauge("bad").set_fn(lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["gauges"]["ok"] == 42.0
    assert snap["gauges"]["bad"] is None   # failing gauge never raises


def test_metric_key_roundtrip_and_sanitization():
    key = metric_key("comm.records", {"site": 3, "topology": "sharded"})
    assert key == "comm.records{site=3,topology=sharded}"
    assert split_key(key) == ("comm.records",
                              {"site": "3", "topology": "sharded"})
    assert split_key("plain") == ("plain", {})
    # label values that would break the key format are sanitized
    assert "{" not in metric_key("m", {"v": "a{b}=c,d"}).split("{", 1)[1][:-1]\
        .split("=", 1)[1]


def test_trace_span_records_wall_time():
    reg = obs.MetricsRegistry()
    with reg.trace("fit", topology="t"):
        pass
    e = reg.snapshot()["histograms"]["phase.fit{topology=t}"]
    assert e["count"] == 1 and e["sum"] >= 0


def test_using_registry_scopes_default():
    base = obs.get_default_registry()
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        assert obs.get_default_registry() is reg
        obs.counter("scoped").inc()
        assert reg.snapshot()["counters"]["scoped"] == 1
    assert obs.get_default_registry() is base
    assert "scoped" not in base.snapshot()["counters"]


def test_prometheus_rendering():
    reg = obs.MetricsRegistry()
    reg.counter("comm.records", site=0).inc(7)
    reg.gauge("tree.records").set(12)
    reg.histogram("serve.latency", buckets=(0.01,),
                  topology="stream").observe(0.005)
    txt = obs.render_prometheus(reg.snapshot())
    assert "# TYPE comm_records_total counter" in txt
    assert 'comm_records_total{site="0"} 7' in txt
    assert "tree_records 12" in txt
    assert "# TYPE serve_latency histogram" in txt
    assert 'serve_latency_bucket{le="0.01",topology="stream"} 1' in txt
    assert 'serve_latency_count{topology="stream"} 1' in txt
    assert ('serve_latency_quantile{quantile="0.5",topology="stream"}'
            in txt)


# ------------------------------------------------------------ layer wiring
def _stream_cfg(**kw):
    base = dict(dim=4, k=3, t=8, leaf_size=64, refresh_every=256,
                micro_batch=32, second_iters=5, seed=0)
    base.update(kw)
    return ServiceConfig(**base)


def _ingest_data(n=600, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def test_latency_stats_compat_shim():
    with obs.using_registry(obs.MetricsRegistry()):
        svc = StreamService(_stream_cfg(), device="cpu")
        empty = svc.latency_stats()
        assert empty["count"] == 0
        assert np.isnan(empty["p50_ms"]) and np.isnan(empty["p99_ms"])
        svc.ingest(_ingest_data())
        svc.refresh()
        svc.score(_ingest_data(70))
        stats = svc.latency_stats()
        assert set(stats) == {"count", "p50_ms", "p99_ms"}
        assert stats["count"] == 70
        assert np.isfinite(stats["p50_ms"])
        assert stats["p50_ms"] <= stats["p99_ms"]
        svc.reset_latency_stats()
        assert svc.latency_stats()["count"] == 0


def test_bounded_latency_state():
    """The unbounded-list leak is gone: latency state is O(ring), not O(n)."""
    with obs.using_registry(obs.MetricsRegistry()):
        svc = StreamService(_stream_cfg(), device="cpu")
        assert not hasattr(svc, "_latencies")
        assert svc._lat._ring.maxlen == obs.DEFAULT_RING


def test_single_host_refresh_stats_and_staleness():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        svc = StreamService(_stream_cfg(), device="cpu")
        assert svc.last_fit is None
        assert svc.seconds_since_install() is None
        svc.ingest(_ingest_data())
        svc.refresh()
        assert svc.last_fit is not None
        assert svc.last_fit.version == int(svc.model.version)
        assert svc.last_fit.records_folded > 0
        assert svc.last_fit.fit_s >= 0
        age = svc.seconds_since_install()
        assert age is not None and age >= 0
        snap = reg.snapshot()
        g = snap["gauges"]["model.seconds_since_install{topology=stream}"]
        assert g is not None and g >= age   # gauge evaluates later => older
        assert snap["histograms"][
            "phase.refresh.fit{topology=stream}"]["count"] >= 1


def test_async_refresh_stats_install_at_poll():
    with obs.using_registry(obs.MetricsRegistry()):
        svc = StreamService(_stream_cfg(async_refresh=True), device="cpu")
        svc.ingest(_ingest_data(200))
        svc.refresh(blocking=False)
        svc.join_refresh()
        assert svc.last_fit is not None
        assert svc.last_fit.version == int(svc.model.version)
        assert svc.last_fit.records_folded > 0


def test_stream_snapshot_covers_tree_and_phases():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        svc = StreamService(_stream_cfg(), device="cpu")
        svc.ingest(_ingest_data())
        svc.refresh()
        svc.score(_ingest_data(40))
        snap = reg.snapshot()
        c, h, g = snap["counters"], snap["histograms"], snap["gauges"]
        summ = svc.cfg.summarizer.name
        assert c[f"tree.leaf_flushes{{summarizer={summ}}}"] >= 2
        assert c["ingest.points{topology=stream}"] == 600
        assert c["score.requests{topology=stream}"] == 40
        assert h[f"phase.ingest.leaf_flush{{summarizer={summ}}}"][
            "count"] >= 2
        assert h["phase.score.fused{topology=stream}"]["count"] >= 1
        assert g[f"tree.records{{summarizer={summ}}}"] > 0
        assert any(k.startswith("kernels.dispatch{") for k in c)


def test_sharded_comm_accounting_matches_refresh_stats():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        cfg = ShardedServiceConfig(
            dim=4, k=3, t=8, n_sites=3, leaf_size=64, refresh_every=256,
            micro_batch=32, second_iters=5, seed=0)
        svc = ShardedStreamService(cfg, device="cpu")
        svc.ingest(_ingest_data(600))
        svc.refresh()
        st = svc.last_refresh
        snap = reg.snapshot()
        c = snap["counters"]
        assert c["comm.rounds{topology=sharded}"] == int(st.version)
        # the LAST refresh's per-site records are the final increments;
        # totals accumulate over all refreshes, so each site's counter is
        # at least its last contribution
        for i, rec in enumerate(st.per_site_records):
            key = f"comm.records{{site={i},topology=sharded}}"
            assert c[key] >= rec
        key0 = "comm.bytes{site=0,topology=sharded}"
        assert c[key0] >= st.payload_bytes
        # per-site tree series carry the site label
        summ = svc.trees[0].cfg.summarizer.name
        assert f"tree.records{{site=0,summarizer={summ}}}" in snap["gauges"]


def test_scores_bit_identical_with_metrics_on_and_off():
    x = _ingest_data(600)
    q = _ingest_data(64, seed=7)

    def run() -> list:
        svc = StreamService(_stream_cfg(), device="cpu")
        svc.ingest(x)
        svc.refresh()
        return svc.score(q)

    with obs.using_registry(obs.MetricsRegistry(enabled=True)):
        res_on = run()
    with obs.using_registry(obs.MetricsRegistry(enabled=False)):
        res_off = run()
    for a, b in zip(res_on, res_off):
        assert a.request_id == b.request_id
        assert a.center == b.center
        assert a.distance == b.distance            # bit-identical
        assert a.outlier_score == b.outlier_score
        assert a.is_outlier == b.is_outlier


def test_checkpoint_metrics(tmp_path):
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        mgr = CheckpointManager(tmp_path)
        state = {"a": np.arange(100, dtype=np.float32)}
        mgr.save(1, state, blocking=True)
        restored, _ = mgr.restore({"a": np.zeros(100, np.float32)})
        snap = reg.snapshot()
        c = snap["counters"]
        assert c["checkpoint.saves"] == 1
        assert c["checkpoint.restores"] == 1
        assert c["checkpoint.bytes_written"] == 400
        assert c["checkpoint.bytes_read"] == 400
        assert snap["histograms"]["phase.checkpoint.save"]["count"] == 1
        assert snap["histograms"]["phase.checkpoint.restore"]["count"] == 1
        np.testing.assert_array_equal(np.asarray(restored["a"]),
                                      state["a"])


# --------------------------------------------------------------- front door
def _session_snapshot(kind: str) -> dict:
    topo_kw = {}
    if kind in ("stream", "sharded"):
        topo_kw = dict(leaf_size=64, refresh_every=256, micro_batch=32)
    if kind == "sharded":
        topo_kw["sites"] = 2
    cfg = pipeline_config(dim=4, k=3, t=10, topology=kind,
                          second_iters=5, seed=0, **topo_kw)
    x, _ = gauss(n_centers=3, per_center=150, d=4, t=10, seed=0)
    session = Session(cfg, device="cpu")
    session.fit(np.asarray(x, np.float32))
    session.score(np.asarray(x[:40], np.float32))
    return session.stats()


@pytest.mark.parametrize("kind", ["oneshot", "stream", "sharded"])
def test_session_stats_covers_every_topology(kind):
    with obs.using_registry(obs.MetricsRegistry()):
        snap = _session_snapshot(kind)
        h, c = snap["histograms"], snap["counters"]
        # serve latency histogram for this topology
        assert h[f"serve.latency{{topology={kind}}}"]["count"] == 40
        # refresh phase timings
        assert h[f"phase.refresh.fit{{topology={kind}}}"]["count"] >= 1
        # score phases
        assert h[f"phase.score.fused{{topology={kind}}}"]["count"] >= 1
        # kernel-backend dispatch counts
        assert any(k.startswith("kernels.dispatch{") for k in c)
        if kind == "oneshot":
            assert any(k.startswith("comm.records{") for k in c)
            assert any(k.startswith("phase.oneshot.site_summary{")
                       for k in h)
        if kind == "sharded":
            assert c["comm.rounds{topology=sharded}"] >= 1
            assert any(k.startswith("comm.bytes{") for k in c)


def test_session_stats_is_json_and_prom_renderable():
    with obs.using_registry(obs.MetricsRegistry()):
        snap = _session_snapshot("stream")
        json.dumps(snap)
        txt = obs.render_prometheus(snap)
        assert "serve_latency_bucket" in txt


# ------------------------------------------------------ parity with the ref
GRID = dict(dim=4, k=4, t=12, leaf_size=256, refresh_every=1500,
            micro_batch=64, window=3000, seed=5, metric="l1")
# counter families both packages must count alike (kernels.* differ:
# the reference counts per trace, the port per distinct resolution)
FAMILIES = ("tree.", "store.", "refresh.", "comm.", "checkpoint.",
            "ingest.", "score.")


def _no_kernels(snap):
    """The snapshot without its ``kernels.*`` series: the reference counts
    a dispatch when ``jit`` traces it, so its count depends on what the
    process compiled before (``kernels/dispatch.py``)."""
    return {section: {k: v for k, v in snap[section].items()
                      if not split_key(k)[0].startswith(
                          ("kernels.", "phase.kernels."))}
            for section in ("counters", "gauges", "histograms")}


def _links(recorder) -> Tally:
    """(span name, parent span name) over an exported Chrome trace."""
    events = recorder.export_chrome()["traceEvents"]
    names = {e["args"]["span_id"]: e["name"] for e in events}
    return Tally((e["name"], names.get(e["args"]["parent_id"]))
                 for e in events)


def _drive(svc, x, q, mgr):
    for i in range(0, len(x), 700):
        svc.ingest(x[i:i + 700])
    svc.refresh()
    svc.score(q)
    svc.save(mgr, 1)


def _parity_run(kind, tmp_path, store=None):
    """The grid stream through the reference's and the port's service of
    ``kind``, each under a fresh registry: (reference registry, port
    registry)."""
    key = jax.random.key(7)
    x, q = grid(6000, seed=40), grid(100, seed=41)
    out = []
    for pkg in ("ref", "port"):
        kw = dict(GRID)
        if store is not None:
            spec = JStoreSpec if pkg == "ref" else StoreSpec
            kw["store"] = spec(hot_levels=store,
                               directory=str(tmp_path / pkg / "tier"))
        reg = (jobs if pkg == "ref" else obs).MetricsRegistry()
        with (jobs if pkg == "ref" else obs).using_registry(reg):
            if kind == "sharded":
                kw["n_sites"] = 3
                if pkg == "ref":
                    cfg = J.ShardedServiceConfig(**kw)
                    svc = J.ShardedStreamService(cfg, key)
                else:
                    cfg = ShardedServiceConfig(**kw)
                    svc = ShardedStreamService(cfg, JaxReplaySampler(key),
                                               device="cpu")
            elif pkg == "ref":
                cfg = J.ServiceConfig(**kw)
                svc = J.StreamService(cfg, key)
            else:
                cfg = ServiceConfig(**kw)
                svc = StreamService(cfg, JaxReplaySampler(key), device="cpu")
            mgr = (JManager if pkg == "ref" else CheckpointManager)(
                tmp_path / pkg / "ck")
            _drive(svc, x, q, mgr)
            extra = ({} if pkg == "ref" else
                     {"sampler_from_key_data": JaxReplaySampler.from_key_data,
                      "device": "cpu"})
            back = type(svc).restore(cfg, mgr, **extra)
            for s in (svc, back):   # join the spills still in flight
                for tr in getattr(s, "trees", None) or [s.tree]:
                    if tr._store is not None:
                        tr._store.flush()
        out.append(reg)
    return out


@pytest.mark.parametrize("kind,store", [("stream", None), ("stream", 0),
                                        ("sharded", None)])
def test_snapshot_keys_and_counters_match_reference(kind, store, tmp_path):
    """Same metric keys; the same tree / store / refresh / comm /
    checkpoint / ingest / score counter values and histogram counts."""
    jreg, treg = _parity_run(kind, tmp_path, store)
    want, got = (_no_kernels(r.snapshot()) for r in (jreg, treg))
    for section in ("counters", "gauges", "histograms"):
        assert sorted(got[section]) == sorted(want[section]), section
    counted = [k for k in want["counters"] if k.startswith(FAMILIES)]
    assert counted
    assert {k: got["counters"][k] for k in counted} == \
        {k: want["counters"][k] for k in counted}
    assert {k: h["count"] for k, h in got["histograms"].items()} == \
        {k: h["count"] for k, h in want["histograms"].items()}
    if store is not None:
        assert sum(v for k, v in got["counters"].items()
                   if k.startswith("store.spills{")) > 0


@pytest.mark.parametrize("kind", ["stream", "sharded"])
def test_trace_span_names_and_parents_match_reference(kind, tmp_path):
    jreg, treg = _parity_run(kind, tmp_path)
    want, got = _links(jreg.recorder), _links(treg.recorder)
    assert got == want
    assert ("refresh.fit", "refresh") in got
    assert ("ingest.leaf_flush", "ingest") in got


def test_oneshot_comm_and_phases_match_reference():
    """``simulate_coordinator``: the same comm records and bytes per site
    and the same site-summary / second-level spans as the reference's."""
    x = grid(2400, seed=42)
    parts = np.array_split(x, 4)
    key = jax.random.key(7)
    with jobs.using_registry(jobs.MetricsRegistry()) as jreg:
        j_simulate(parts, key, k=4, t=12)
    with obs.using_registry(obs.MetricsRegistry()) as treg:
        simulate_coordinator(parts, JaxReplaySampler(key), k=4, t=12,
                             device="cpu")
    want, got = jreg.snapshot(), treg.snapshot()
    comm = {k: v for k, v in want["counters"].items()
            if k.startswith("comm.")}
    assert len(comm) == 9   # records + bytes per site, rounds
    assert {k: got["counters"][k] for k in comm} == comm
    phases = sorted(k for k in want["histograms"]
                    if k.startswith("phase.oneshot"))
    assert phases == sorted(k for k in got["histograms"]
                            if k.startswith("phase.oneshot"))


def test_shard_map_comm_counters_match_reference(tmp_path):
    """``distributed_cluster`` (one gloo rank, the reference's one-device
    mesh): the same ``comm.records``, ``comm.bytes`` and ``comm.rounds``
    as the reference's shard_map path, the valid records counted on the
    card."""
    import jax.numpy as jnp
    import torch.distributed as dist

    import repro.core.collective as JC
    from repro.core.distributed import distributed_cluster as j_dist
    from repro_torch.core.collective import init_sites
    from repro_torch.core.distributed import distributed_cluster
    x = grid(2400, seed=23)
    key = jax.random.key(24)
    kw = dict(k=4, t=20, second_iters=10)
    with jobs.using_registry(jobs.MetricsRegistry()) as jreg:
        j_dist(jnp.asarray(x)[None], key, JC.sites_mesh(1), **kw)
    init_sites(0, ["cpu"], init_method=f"file://{tmp_path}/store")
    try:
        with obs.using_registry(obs.MetricsRegistry()) as treg:
            res = distributed_cluster(x[None], JaxReplaySampler(key), **kw,
                                      device="cpu")
    finally:
        dist.destroy_process_group()
    want = {k: v for k, v in jreg.snapshot()["counters"].items()
            if k.startswith("comm.")}
    got = {k: v for k, v in treg.snapshot()["counters"].items()
           if k.startswith("comm.")}
    assert len(want) == 3 and got == want
    assert got["comm.records{path=shard_map,site=0}"] == \
        int((res.summary_ids >= 0).sum())


def test_observe_count_is_count_observes():
    """``Histogram.observe(v, n)`` (one per drained block) leaves the state
    ``n`` single observes leave, its sum added in the same order."""
    reg = obs.MetricsRegistry()
    one, many = reg.histogram("a", ring=50), reg.histogram("b", ring=50)
    rng = np.random.default_rng(3)
    for v, n in zip(rng.exponential(0.01, 40), rng.integers(0, 9, 40)):
        for _ in range(int(n)):
            one.observe(v)
        many.observe(v, int(n))
    assert many.snapshot_entry() == one.snapshot_entry()
    assert list(many._ring) == list(one._ring)
