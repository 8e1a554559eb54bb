"""The port's front door against the reference's, on the CPU.

``PipelineConfig``: for the ``examples/`` artifacts and a set of configs
covering every topology kind and section (``serving``, ``tracing``,
``store`` in its bare-bool, bare-int and dict forms, a summarizer with
params, kernel policies with tiles and the autotuner), the port's
``to_json()`` must equal the reference's byte for byte; the reference's
invalid configs raise ``ValueError`` in both packages; a version-1 payload
warns and upgrades; an artifact's ``"pallas"`` backend reads as the port's
``"cuda"``; ``service_config()`` and ``sharded_config()`` equal the
reference's field for field.

``Session``: the oneshot (4 sites), stream (with and without a
``store``) and sharded topologies under ``JaxReplaySampler`` (the
reference's draws)
against the reference's ``Session`` on an integer grid
(``test_torch_stream.grid``), where every distance between two rows is
exact in f32 (ROADMAP.md, queue 3 item 1).  Centers, ids, versions,
records and communication are held bit for bit.  A distance to a fitted
center is not exact: under l1 it is a sum of |x - c| and the threshold
and scores are held bit for bit, under l2sq it is a dot product that
XLA's CPU dot and torch sum in other orders (queue 3 item 4), so the
threshold is held to 1e-6 of the expansion's magnitude and scores to rtol
1e-5.  The cost, a weighted sum over the records in another order, is held
to rtol 1e-5 (as ``test_torch_oneshot.py`` holds it).  A refresh with no
new data is pure; ``save`` / ``load`` round-trip bit for bit and cross
between the packages both ways, ``kernels="cuda"`` included (written as
the reference's ``"pallas"``); the error surface is the reference's.  The
serving verbs, ``stats`` and ``dump_trace`` work on a fitted session, and a
``tracing`` section configures the flight recorder.

``topology.use_shard_map``: with four ranks of a gloo group
(``test_torch_collective.spawn_ranks``) ``Session.fit`` is bit for bit
the direct ``distributed_cluster`` and a save / load re-scores bit for
bit (the reference's ``tests/test_api.py`` subprocess test, which cannot
run on four CPU devices under the installed jax: ROADMAP.md).
"""
import contextlib
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as J
import repro.kernels.dispatch as jdispatch
import repro.store as jstore
import repro.summarize as jsummarize
from repro.api.cli import load_config_file as j_load_config_file
from repro_torch import obs as tobs
from repro_torch.api import (OneshotEngine, PipelineConfig, Session,
                             pipeline_config)
from repro_torch.api.cli import load_config_file
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.core.collective import init_sites
from repro_torch.core.distributed import distributed_cluster
from repro_torch.core.sampler import TorchSampler
from repro_torch.store import StoreSpec
from repro_torch.stream import (ServiceConfig, ShardedServiceConfig,
                                ShardedStreamService, StreamService)
from repro_torch.summarize import summarizer_policy
from test_torch_collective import spawn_ranks
from test_torch_replay import JaxReplaySampler
from test_torch_stream import grid

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
ARTIFACTS = ("oneshot.json", "stream.toml", "stream_store.json")


# ------------------------------------------------------------- serialization
def _cases():
    """Keyword sets both packages' ``pipeline_config`` take as they are."""
    return {
        "oneshot_default": dict(dim=3, k=4, t=12),
        "oneshot_l1_adversarial": dict(dim=3, k=4, t=12, sites=5,
                                       partition="adversarial", metric="l1",
                                       seed=9),
        "stream_uniform_blocked": dict(
            dim=5, k=2, t=0, topology="stream", leaf_size=128,
            refresh_every=512, window=4096, summarizer="uniform",
            kernels="blocked"),
        "stream_store_bool": dict(dim=4, k=3, t=10, topology="stream",
                                  store=True, kernels="ref"),
        "stream_store_int": dict(dim=4, k=3, t=10, topology="stream",
                                 store=2, async_refresh=True,
                                 kernels={"backend": "int8",
                                          "block_n": 4096}),
        "stream_store_dict": dict(
            dim=4, k=3, t=10, topology="stream", window=9000,
            store={"hot_levels": 1, "incremental_refresh": False,
                   "warm_start_frac": 0.5},
            kernels={"backend": "blocked", "autotune": True}),
        "sharded_coreset": dict(
            dim=2, k=3, t=7, topology="sharded", sites=3,
            site_budget="paper", async_refresh=True, micro_batch=64,
            summarizer={"name": "coreset", "params": [["budget", 64]]},
            kernels={"backend": "ref", "block_n": 256}, store=0),
        "serving_and_tracing_dicts": dict(
            dim=3, k=4, t=12, sites=2,
            serving={"queue_bound": 64, "batch_window_ms": 1,
                     "shed_policy": "wait", "tenant_quota": 8,
                     "max_batch": 32},
            tracing={"sample_rate": 0.25, "ring": 128, "seed": 3}),
        "serving_and_tracing_bare": dict(dim=3, k=4, t=12,
                                         serving="shed", tracing=0.5),
        "tracing_off": dict(dim=3, k=4, t=12, topology="stream",
                            tracing=False, serving="wait"),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_to_json_is_the_references_byte_for_byte(case):
    kw = _cases()[case]
    want = J.pipeline_config(**kw)
    got = pipeline_config(**kw)
    assert got.to_json() == want.to_json()
    assert got.to_dict() == want.to_dict()
    assert PipelineConfig.from_json(want.to_json()) == got
    assert J.PipelineConfig.from_json(got.to_json()) == want


@pytest.mark.parametrize("name", ARTIFACTS)
def test_example_artifacts_read_as_the_references(name):
    # examples/oneshot.json is a version-1 artifact
    with pytest.warns(UserWarning) if name == "oneshot.json" else \
            contextlib.nullcontext():
        got, got_data = load_config_file(EXAMPLES / name)
        want, want_data = j_load_config_file(EXAMPLES / name)
    assert got.to_json() == want.to_json()
    assert got_data == want_data


# the reference's invalid configs (tests/test_api.py)
BAD = [
    dict(dim=0, k=4, t=10),
    dict(dim=3, k=0, t=10),
    dict(dim=3, k=4, t=-1),
    dict(dim=3, k=4, t=10, metric="chebyshev"),
    dict(dim=3, k=4, t=10, topology="ring"),
    dict(dim=3, k=4, t=10, topology="stream", sites=3),
    dict(dim=3, k=4, t=10, window=100),
    dict(dim=3, k=4, t=10, async_refresh=True),
    dict(dim=3, k=4, t=10, refresh_every=4096),
    dict(dim=3, k=4, t=10, leaf_size=512),
    dict(dim=3, k=4, t=10, topology="stream", partition="adversarial"),
    dict(dim=3, k=4, t=10, topology="stream", site_budget="paper"),
    dict(dim=3, k=4, t=10, topology="stream", use_shard_map=True),
    dict(dim=3, k=4, t=10, topology="sharded", sites=0),
    dict(dim=3, k=4, t=10, topology="stream", window=0),
    dict(dim=3, k=4, t=10, summarizer="nope"),
    dict(dim=3, k=4, t=10, use_shard_map=True, summarizer="ball_cover"),
    dict(dim=3, k=4, t=10, kernels={"backend": "auto", "block_n": 0}),
    dict(dim=3, k=4, t=10, store=1),                     # oneshot store
]


@pytest.mark.parametrize("idx", range(len(BAD)))
def test_invalid_configs_raise_in_both_packages(idx):
    with pytest.raises(ValueError) as want:
        J.pipeline_config(**BAD[idx])
    with pytest.raises(ValueError) as got:
        pipeline_config(**BAD[idx])
    assert str(got.value) == str(want.value)


def test_from_dict_rejects_what_the_reference_rejects():
    good = pipeline_config(dim=3, k=4, t=12).to_dict()
    for bad, match in (({**good, "extra": 1}, "unknown config keys"),
                       ({**good, "topology": {**good["topology"],
                                              "n_sites": 2}},
                        "unknown topology keys"),
                       ({k: v for k, v in good.items() if k != "problem"},
                        "missing"),
                       ({**good, "version": 99}, "version")):
        for cls in (PipelineConfig, J.PipelineConfig):
            with pytest.raises(ValueError, match=match):
                cls.from_dict(bad)


def test_v1_payload_warns_and_upgrades():
    d = pipeline_config(dim=3, k=4, t=12, sites=2).to_dict()
    v1 = {**d, "version": 1}
    with pytest.warns(UserWarning, match="version-1"):
        got = PipelineConfig.from_dict(v1)
    assert got == PipelineConfig.from_dict(d)
    assert got.to_dict()["version"] == 2


def test_package_surface_is_the_references():
    """``repro_torch.__all__`` is the reference's ``repro.__all__`` name
    for name, and every name resolves."""
    import repro
    import repro_torch
    assert sorted(repro_torch.__all__) == sorted(repro.__all__)
    missing = [n for n in repro_torch.__all__ if not hasattr(repro_torch, n)]
    assert missing == []


def test_pallas_backend_reads_as_cuda():
    assert pipeline_config(dim=3, k=4, t=12,
                           kernels="pallas").kernels.backend == "cuda"
    d = J.pipeline_config(dim=3, k=4, t=12,
                          kernels=jdispatch.KernelPolicy(
                              backend="pallas", block_n=512,
                              autotune=True)).to_dict()
    got = PipelineConfig.from_dict(d)
    assert got.kernels == KernelPolicy(backend="cuda", block_n=512,
                                       autotune=True)
    # the port writes its "cuda" back as the reference's "pallas": the
    # artifact is the reference's byte for byte and loads there
    assert got.to_dict()["kernels"]["backend"] == "pallas"
    assert got.to_json() == J.PipelineConfig.from_dict(d).to_json()
    assert J.PipelineConfig.from_dict(got.to_dict()) == \
        J.PipelineConfig.from_dict(d)
    with pytest.raises(ValueError):
        KernelPolicy(backend="pallas")


def test_cuda_session_checkpoint_loads_in_the_reference(tmp_path):
    """A port ``Session.save`` with ``kernels="cuda"`` loads through the
    reference's ``Session.load`` (it raised "unknown backend 'cuda'" when the
    port wrote ``"cuda"`` into the artifact)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(600, 4)).astype(np.float32)
    cfg = pipeline_config(dim=4, k=3, t=10, sites=3, kernels="cuda")
    sess = Session(cfg, device="cpu")
    sess.ingest(x)
    sess.refresh()
    sess.save(tmp_path)
    back = J.Session.load(tmp_path)
    assert back.config.kernels == jdispatch.KernelPolicy(backend="pallas")
    assert back.config.to_json() == cfg.to_json()
    np.testing.assert_array_equal(np.asarray(back.model.centers),
                                  sess.model.centers.numpy())


def _projections(**over):
    """(port, reference) pipeline configs with every projected field set."""
    kw = dict(dict(dim=4, k=3, t=10, topology="stream", leaf_size=512,
                   refresh_every=2048, micro_batch=128, window=9000,
                   async_refresh=True, second_iters=7, seed=4,
                   summarizer=summarizer_policy("uniform", budget=32),
                   kernels=KernelPolicy(backend="blocked", block_n=1024),
                   store=StoreSpec(hot_levels=1)), **over)
    jkw = {**kw, "summarizer": jsummarize.summarizer_policy("uniform",
                                                            budget=32),
           "kernels": jdispatch.KernelPolicy(backend="blocked",
                                             block_n=1024),
           "store": jstore.StoreSpec(hot_levels=1)}
    return pipeline_config(**kw), J.pipeline_config(**jkw)


def assert_fields_equal(got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name


def test_service_config_is_the_references_field_for_field():
    got, want = _projections()
    assert isinstance(got.service_config(), ServiceConfig)
    assert_fields_equal(got.service_config(), want.service_config())
    with pytest.raises(ValueError, match="stream"):
        pipeline_config(dim=3, k=4, t=12).service_config()


@pytest.mark.parametrize("sites,site_budget,use_shard_map", [
    (2, "full", False), (4, "paper", True), (20, "paper", False)])
def test_sharded_config_is_the_references_field_for_field(
        sites, site_budget, use_shard_map):
    got, want = _projections(topology="sharded", sites=sites,
                             site_budget=site_budget,
                             use_shard_map=use_shard_map)
    cfg = got.sharded_config()
    assert isinstance(cfg, ShardedServiceConfig)
    assert_fields_equal(cfg, want.sharded_config())
    assert cfg.site_t() == want.sharded_config().site_t()
    with pytest.raises(ValueError, match="sharded"):
        pipeline_config(dim=3, k=4, t=12,
                        topology="stream").sharded_config()


# ------------------------------------------------------- session parity
def _expansion_scale(rows, centers):
    rows = np.asarray(rows, np.float64)
    c = np.asarray(centers, np.float64)
    return (rows ** 2).sum(1).max() + (c ** 2).sum(1).max()


def assert_models_match(got, want, metric, rows):
    """Centers, version and trained mass bit for bit; the threshold bit for
    bit under l1, within 1e-6 of the expansion's magnitude under l2sq; the
    cost to rtol 1e-5."""
    for name in ("centers", "version", "trained_weight"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    g, w = float(got.threshold), float(want.threshold)
    if metric == "l1":
        assert g == w, (g, w)
    else:
        assert abs(g - w) <= 1e-6 * _expansion_scale(rows, want.centers)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)


def assert_scores_match(got, want, metric, same_ids=True):
    if same_ids:
        assert [r.request_id for r in got] == [r.request_id for r in want]
    assert [r.center for r in got] == [r.center for r in want]
    assert [r.is_outlier for r in got] == [r.is_outlier for r in want]
    for name in ("distance", "outlier_score"):
        g = np.array([getattr(r, name) for r in got], np.float32)
        w = np.array([getattr(r, name) for r in want], np.float32)
        if metric == "l1":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)


def _sessions(kw, seed=0):
    """(port, reference) sessions on one config, the port under the
    reference's draws."""
    want = J.Session(J.pipeline_config(**kw))
    got = Session(pipeline_config(**kw), device="cpu",
                  sampler=JaxReplaySampler(jax.random.key(kw.get("seed",
                                                                 seed))))
    return got, want


ONESHOT = dict(dim=4, k=4, t=12, sites=4, seed=3)


@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_oneshot_session_matches_reference(metric):
    x = grid(2400, seed=21)
    q = grid(300, seed=22)
    got, want = _sessions({**ONESHOT, "metric": metric})
    mg, mw = got.fit(x), want.fit(x)
    for name in ("centers", "outlier_ids", "summary_ids", "summary_weights"):
        np.testing.assert_array_equal(got.result[name], want.result[name],
                                      err_msg=name)
    assert got.result["comm_records"] == want.result["comm_records"]
    np.testing.assert_allclose(got.result["cost"], want.result["cost"],
                               rtol=1e-5)
    assert sorted(got.result) == sorted(want.result)
    assert_models_match(mg, mw, metric, x[want.result["summary_ids"]])
    assert_scores_match(got.score(q), want.score(q), metric)
    assert isinstance(got.engine, OneshotEngine)
    assert got.last_fit.records_folded == want.last_fit.records_folded
    assert got.store_stats() is None and want.store_stats() is None


def test_oneshot_engine_is_the_sessions_engine():
    x = grid(1600, seed=23)
    kw = {**ONESHOT, "metric": "l1"}
    sess = Session(pipeline_config(**kw), device="cpu",
                   sampler=JaxReplaySampler(jax.random.key(3)))
    eng = OneshotEngine(pipeline_config(**kw), device="cpu",
                        sampler=JaxReplaySampler(jax.random.key(3)))
    sess.fit(x)
    eng.ingest(x[:800])
    eng.ingest(x[800:])
    eng.refresh()
    for name in ("centers", "outlier_ids", "summary_ids"):
        np.testing.assert_array_equal(eng.result[name], sess.result[name])
    assert eng.total_ingested == 1600


STREAM = dict(dim=4, k=4, t=12, topology="stream", leaf_size=256,
              refresh_every=1500, micro_batch=64, window=3000, seed=5)


@pytest.mark.parametrize("store", [None, 0], ids=["resident", "store"])
@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_stream_session_matches_reference(metric, store, tmp_path):
    with tobs.using_registry(tobs.MetricsRegistry()) as reg:
        _stream_session_matches_reference(metric, store, tmp_path, reg)


def _stream_session_matches_reference(metric, store, tmp_path, reg):
    kw = {**STREAM, "metric": metric}
    if store is not None:
        kw["store"] = {"hot_levels": store, "directory": str(tmp_path),
                       "warm_start_frac": 0.3}
    got, want = _sessions(kw)
    x = grid(6000, seed=24)
    for i in range(0, len(x), 700):
        got.ingest(x[i:i + 700])
        want.ingest(x[i:i + 700])
        assert (got.model is None) == (want.model is None)
    mg, mw = got.refresh(), want.refresh()
    assert got.store_stats() == want.store_stats()
    root = want.engine.tree.packed_root()[0]   # (pages the reference in)
    assert_models_match(mg, mw, metric, root)
    assert got.last_fit.records_folded == want.last_fit.records_folded
    q = grid(200, seed=25)
    assert_scores_match(got.score(q), want.score(q), metric)
    assert got.result is None and want.result is None
    if store is not None:
        assert got.store_stats()["spills"] > 0
        c = reg.snapshot()["counters"]
        assert (c["refresh.skipped{topology=stream}"],
                c["refresh.warm_starts{topology=stream}"]) == \
            (1, 0)   # the final refresh: the root did not change


SHARDED = dict(dim=4, k=4, t=12, topology="sharded", sites=4,
               leaf_size=256, refresh_every=1500, micro_batch=64,
               window=3000, seed=6)


@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_sharded_session_matches_reference(metric):
    got, want = _sessions({**SHARDED, "metric": metric})
    x = grid(8000, seed=35)
    for i in range(0, len(x), 700):
        got.ingest(x[i:i + 700])
        want.ingest(x[i:i + 700])
        assert (got.model is None) == (want.model is None)
    for svc in (got, want):
        svc.ingest(x[:50], site=3)
    mg, mw = got.refresh(), want.refresh()
    roots = np.concatenate([tr.root()[0] for tr in want.engine.trees])
    assert_models_match(mg, mw, metric, roots)
    assert tuple(got.engine.last_refresh) == tuple(want.engine.last_refresh)
    assert got.last_fit.records_folded == want.last_fit.records_folded
    q = grid(200, seed=36)
    assert_scores_match(got.score(q), want.score(q), metric)
    assert isinstance(got.engine, ShardedStreamService)
    assert got.result is None and got.store_stats() is None


def test_sharded_session_is_the_service(tmp_path):
    """The facade adds no math: a sharded Session's model and drain are
    the service's on the same config and sampler, bit for bit, and its
    store tallies are the sum over the sites' trees."""
    kw = {**SHARDED, "window": None,
          "store": {"hot_levels": 1, "directory": str(tmp_path)}}
    cfg = pipeline_config(**kw)
    sess = Session(cfg, device="cpu", sampler=TorchSampler(7))
    svc = ShardedStreamService(cfg.sharded_config(), TorchSampler(7),
                               device="cpu")
    x = grid(9000, seed=37)
    for i in range(0, len(x), 1000):
        sess.ingest(x[i:i + 1000])
        svc.ingest(x[i:i + 1000])
    a, b = sess.refresh(), svc.refresh()
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    q = grid(100, seed=38)
    assert_scores_match(sess.score(q), svc.score(q), "l1")
    totals = sess.store_stats()
    assert totals["spills"] == sum(tr._store.stats()["spills"]
                                   for tr in svc.trees) > 0


def test_oneshot_refresh_is_pure():
    x = grid(1600, seed=26)
    sess = Session(pipeline_config(dim=4, k=4, t=12, sites=2), device="cpu")
    m1 = sess.fit(x)
    r1 = {k: v for k, v in sess.result.items()}
    m2 = sess.refresh()
    assert torch.equal(m1.centers, m2.centers)
    assert float(m1.threshold) == float(m2.threshold)
    assert int(m2.version) == int(m1.version) + 1
    for name in ("outlier_ids", "summary_ids"):
        np.testing.assert_array_equal(sess.result[name], r1[name])


# ------------------------------------------------------------- save / load
KINDS = {"oneshot": ONESHOT, "stream": STREAM, "sharded": SHARDED}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_save_load_score_bit_identical(tmp_path, kind):
    x = grid(2000, seed=27)
    kw = KINDS[kind]
    sess = Session(pipeline_config(**kw), device="cpu")
    sess.fit(x)
    q = x[:100]
    before = sess.score(q)
    assert sess.save(tmp_path) == 1
    restored = Session.load(tmp_path, device="cpu")
    assert restored.config == sess.config
    # request ids continue from the saved counter
    assert_scores_match(restored.score(q), before, "l1", same_ids=False)
    assert restored.engine._next_id == 2 * len(q)
    assert int(restored.model.version) == int(sess.model.version)
    if kind == "oneshot":
        for key in ("outlier_ids", "summary_ids", "summary_weights",
                    "centers"):
            np.testing.assert_array_equal(restored.result[key],
                                          sess.result[key])
        assert restored.result["cost"] == sess.result["cost"]
        assert restored.result["comm_records"] == \
            sess.result["comm_records"]
    # the restored session keeps working: ingest more, refresh, score
    restored.ingest(x[:64])
    restored.refresh()
    assert int(restored.model.version) == int(sess.model.version) + 1
    assert sess.save(tmp_path) == 2


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_checkpoints_cross_between_packages(tmp_path, kind):
    """A reference ``Session.save`` loads in the port and scores as the
    reference does, and the other way round (l1: scores bit for bit)."""
    x = grid(2000, seed=28)
    q = grid(100, seed=29)
    kw = {**KINDS[kind], "metric": "l1"}
    ref = J.Session(J.pipeline_config(**kw))
    ref.fit(x)
    ref.save(tmp_path / "ref")
    got = Session.load(tmp_path / "ref", device="cpu",
                       sampler_from_key_data=JaxReplaySampler.from_key_data)
    assert_scores_match(got.score(q), ref.score(q), "l1")

    port = Session(pipeline_config(**kw), device="cpu",
                   sampler=JaxReplaySampler(jax.random.key(kw["seed"])))
    port.fit(x)
    port.save(tmp_path / "port")
    back = J.Session.load(tmp_path / "port")
    assert_scores_match(port.score(q), back.score(q), "l1")
    if kind != "oneshot":
        # both continue on the same draws: ingest more and refit
        got.ingest(x[:1500])
        ref.ingest(x[:1500])
        assert_models_match(got.refresh(), ref.refresh(), "l1", None)


def test_load_refuses_checkpoint_without_embedded_config(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    svc = StreamService(ServiceConfig(dim=4, k=4, t=12, leaf_size=256),
                        device="cpu")
    svc.ingest(grid(512, seed=30))
    svc.refresh()
    svc.save(CheckpointManager(tmp_path), step=1)
    with pytest.raises(ValueError, match="embedded pipeline config"):
        Session.load(tmp_path, device="cpu")


# ------------------------------------------------------------ error surface
def test_session_error_surface():
    x = grid(400, seed=31)
    sess = Session(pipeline_config(dim=4, k=4, t=12), device="cpu")
    with pytest.raises(RuntimeError, match="refresh"):
        sess.refresh()                  # a refresh before any ingest
    with pytest.raises(RuntimeError, match="refresh"):
        sess.score(x[:2])
    with pytest.raises(ValueError, match="unit-weight"):
        sess.ingest(x[:4], np.ones(4))
    with pytest.raises(ValueError, match="sharded"):
        sess.ingest(x[:4], site=0)
    with pytest.raises(ValueError, match="(n, 4)"):
        sess.ingest(x[:4, :2])
    stream = Session(pipeline_config(dim=4, k=4, t=12, topology="stream"),
                     device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        stream.ingest(x[:4], site=0)
    with pytest.raises(RuntimeError, match="refresh"):
        stream.refresh()


@pytest.mark.parametrize("verb", ["serve", "score_stream", "submit_stream",
                                  "stats", "dump_trace"])
def test_queue4_verbs_raise_naming_the_queue(verb, tmp_path):
    """The verbs that raised before the serving scheduler and the telemetry
    plane were ported now work on a fitted session (the name is kept)."""
    x = grid(400, seed=31)
    with tobs.using_registry(tobs.MetricsRegistry()):
        sess = Session(pipeline_config(dim=4, k=4, t=12), device="cpu")
        sess.fit(x)
        want = sess.score(x[:8])
        if verb == "serve":
            sched = sess.serve()
            assert sess.serve() is sched and sess.serving is sched
        elif verb == "score_stream":
            assert_scores_match(
                list(sess.score_stream(x[:8], timeout=60.0)), want, "l2sq",
                same_ids=False)
        elif verb == "submit_stream":
            tickets = sess.submit_stream(x[:8])
            assert [t.result(timeout=60.0).center for t in tickets] == \
                [r.center for r in want]
        elif verb == "stats":
            snap = sess.stats()
            assert snap["version"] == tobs.SNAPSHOT_VERSION
            assert snap["counters"]["refresh.count{topology=oneshot}"] == 1
        else:
            path = sess.dump_trace(tmp_path / "t.json")
            assert "traceEvents" in json.loads(Path(path).read_text())
        with sess as s:         # the context manager closes the scheduler
            assert s is sess
        assert sess.serving is None
        sess.close()
        assert len(sess.score(x[:2])) == 2   # sync verbs outlive close()


@pytest.mark.parametrize("kw,queue", [
    (dict(tracing=0.5), "queue 4"),
    (dict(tracing=False, topology="stream"), "queue 4"),
])
def test_unported_topologies_and_tracing_raise(kw, queue):
    """A config's ``tracing`` section configures the flight recorder (it
    raised naming ``queue`` before the recorder was ported)."""
    cfg = pipeline_config(dim=4, k=4, t=12, **kw)
    with tobs.using_registry(tobs.MetricsRegistry()):
        Session(cfg, device="cpu")
        rec = tobs.get_default_recorder()
        assert (rec.enabled, rec.sample_rate) == (
            cfg.tracing.enabled, cfg.tracing.sample_rate)


@pytest.mark.parametrize("kw", [dict(topology="sharded", sites=2),
                                dict(use_shard_map=True, sites=2)],
                         ids=["sharded", "shard_map"])
def test_sharded_topology_and_shard_map_sessions_build(kw):
    """What raised until the sharded topology was ported: both configs
    build a Session on the reference's layer, and ``sharded_config()``
    projects."""
    cfg = pipeline_config(dim=4, k=4, t=12, **kw)
    sess = Session(cfg, device="cpu")
    if kw.get("topology") == "sharded":
        assert isinstance(sess.engine, ShardedStreamService)
        assert len(sess.engine.trees) == cfg.sharded_config().n_sites == 2
    else:
        assert isinstance(sess.engine, OneshotEngine)


def test_run_oneshot_shard_map_errors(tmp_path):
    """The reference's two errors: rows not divisible by ``sites``, and
    no group of ``sites`` ranks (its "needs >= s devices")."""
    from repro_torch.api.session import _run_oneshot
    cfg = pipeline_config(dim=4, k=4, t=12, sites=2, use_shard_map=True)
    with pytest.raises(ValueError, match="divisible by sites=2"):
        _run_oneshot(grid(41, seed=32), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="group of 2 ranks.*have 0"):
        _run_oneshot(grid(40, seed=32), cfg, device="cpu")
    init_sites(0, ["cpu"], init_method=f"file://{tmp_path}/store")
    try:
        with pytest.raises(RuntimeError, match="group of 2 ranks.*have 1"):
            Session(cfg, device="cpu").fit(grid(40, seed=32))
    finally:
        torch.distributed.destroy_process_group()


def test_load_restores_a_reference_sharded_checkpoint(tmp_path):
    x = grid(800, seed=34)
    kw = dict(dim=4, k=4, t=12, topology="sharded", sites=2, leaf_size=256,
              metric="l1")
    ref = J.Session(J.pipeline_config(**kw))
    ref.fit(x)
    ref.save(tmp_path)
    got = Session.load(tmp_path, device="cpu",
                       sampler_from_key_data=JaxReplaySampler.from_key_data)
    assert got.config == pipeline_config(**kw)
    assert len(got.engine.trees) == 2
    q = grid(64, seed=39)
    assert_scores_match(got.score(q), ref.score(q), "l1")


SHARD_MAP = dict(dim=4, k=4, t=16, sites=4, use_shard_map=True, seed=11)


def _shard_map_rank(rank, n, workdir):
    x = grid(2000, seed=40)
    cfg = pipeline_config(**SHARD_MAP)
    sess = Session(cfg, device="cpu")
    sess.fit(x)
    res = distributed_cluster(x.reshape(4, -1, 4), TorchSampler(11), k=4,
                              t=16, summarizer=cfg.summarizer,
                              policy=cfg.kernels, device="cpu")
    out = res.outlier_ids.numpy()
    q = x[:64]
    before = sess.score(q)
    sess.save(f"{workdir}/ckpt{rank}")
    after = Session.load(f"{workdir}/ckpt{rank}", device="cpu").score(q)
    return {"result": sess.result,
            "centers_equal": np.array_equal(sess.result["centers"],
                                            res.centers.numpy()),
            "cost_equal": sess.result["cost"] == float(res.cost),
            "outliers_equal": np.array_equal(sess.result["outlier_ids"],
                                             out[out >= 0]),
            "reload_scores_equal": [tuple(a)[1:5] for a in before]
            == [tuple(b)[1:5] for b in after]}


def test_shard_map_session_is_direct_distributed_cluster(tmp_path):
    """Four ranks: each rank's ``Session.fit`` under ``use_shard_map`` is
    its direct ``distributed_cluster`` call bit for bit, and a save / load
    re-scores bit for bit (the reference's ``tests/test_api.py``
    ``_ONESHOT_SHARD_MAP_EQ``)."""
    ranks = spawn_ranks(_shard_map_rank, 4, tmp_path)
    for got in ranks:
        assert got["centers_equal"] and got["cost_equal"]
        assert got["outliers_equal"] and got["reload_scores_equal"]
        for key in ("centers", "outlier_ids", "summary_ids",
                    "summary_weights"):
            np.testing.assert_array_equal(got["result"][key],
                                          ranks[0]["result"][key])
        assert got["result"]["comm_records"] == len(
            got["result"]["summary_ids"])


def test_session_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(pipeline_config(dim=4, k=4, t=12))
    with pytest.raises(RuntimeError, match="cuda"):
        Session(pipeline_config(dim=4, k=4, t=12, topology="stream"))


def test_serialized_artifact_runs_the_same_session():
    """A config round-tripped through JSON text drives the same fit."""
    x = grid(1600, seed=33)
    cfg = pipeline_config(**ONESHOT)
    a = Session(cfg, device="cpu")
    b = Session(PipelineConfig.from_json(json.dumps(json.loads(
        cfg.to_json()))), device="cpu")
    assert torch.equal(a.fit(x).centers, b.fit(x).centers)
