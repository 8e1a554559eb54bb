"""The port's sharded streaming service against the reference's, on the CPU.

Under ``JaxReplaySampler`` (the reference's draws), on the integer grid of
``test_torch_stream`` (every distance between rows exact in f32), the
port's ``ShardedStreamService`` must route rows to the reference's sites
(round robin resumed across calls, ``site=`` pinning), keep the
reference's per-site trees leaf for leaf (a site's window is ceil(W/s)),
refresh on the reference's cadence to its versions, models and
``RefreshStats``, skip and warm-start as it does under a ``store``, and
drain its results.  As in ``test_torch_stream``, l1 is held bit for bit;
under l2sq the threshold is held to 1e-6 of the expansion's magnitude and
drained distances and scores to rtol 1e-5 (ROADMAP.md queue 3 item 4).

Checkpoints written by either package restore in the other, with the
format, ``n_sites`` and service-kind guards.  With four ranks of a gloo
group (``use_shard_map=True``) the collective refresh equals the
host-simulated one bit for bit.  The reference's single-host coverage
check (``tests/test_stream_sharded.py:72``, red under the installed jax)
is not carried over: the port is held to the reference's values instead.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.stream as J
from repro import obs
from repro_torch import obs as tobs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.store import StoreSpec as JStoreSpec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.sampler import TorchSampler
from repro_torch.store import StoreSpec
from repro_torch.stream import (RefreshStats, ServiceConfig,
                                ShardedServiceConfig, ShardedStreamService,
                                StreamService)
from test_torch_collective import spawn_ranks
from test_torch_replay import JaxReplaySampler
from test_torch_stream import (assert_models_equal, assert_results_equal,
                               assert_state_equal, grid)

torch.set_num_threads(1)

SH = dict(dim=4, k=4, t=12, n_sites=4, leaf_size=256, refresh_every=1500,
          micro_batch=64, window=3000, seed=5)


def _pair(key, **over):
    kw = {**SH, **over}
    want = J.ShardedStreamService(J.ShardedServiceConfig(**kw), key)
    got = ShardedStreamService(ShardedServiceConfig(**kw),
                               JaxReplaySampler(key), device="cpu")
    return got, want


def _version(svc):
    return 0 if svc.model is None else int(svc.model.version)


def _root(svc):
    """The gathered root's points, the scale of an l2sq threshold."""
    return np.concatenate([tr.root()[0] for tr in svc.trees])


def assert_sites_equal(got, want):
    assert got._routed == want._routed
    assert len(got.trees) == len(want.trees)
    for g, w in zip(got.trees, want.trees):
        assert_state_equal(g.pack_state(), w.pack_state())


@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_sharded_service_matches_reference(metric):
    got, want = _pair(jax.random.key(5), metric=metric)
    x = grid(8000, seed=0)
    versions = []
    for i in range(0, len(x), 700):
        want.ingest(x[i:i + 700])
        got.ingest(x[i:i + 700])
        versions.append((_version(got), _version(want)))
    assert all(g == w for g, w in versions) and versions[-1][0] >= 4
    assert got._since_refresh == want._since_refresh
    assert_sites_equal(got, want)
    root = None if metric == "l1" else _root(want)
    assert_models_equal(got.model, want.model, root)
    assert isinstance(got.last_refresh, RefreshStats)
    assert tuple(got.last_refresh) == tuple(want.last_refresh)
    assert got.last_refresh.path == "host-sim"
    assert (got.num_records, got.total_ingested) == (want.num_records,
                                                     want.total_ingested)
    np.testing.assert_allclose(got.total_weight, want.total_weight,
                               rtol=1e-6)
    q = grid(200, seed=9)
    assert_results_equal(got.score(q), want.score(q), exact=metric == "l1")
    assert_models_equal(got.refresh(), want.refresh(), root)
    assert tuple(got.last_refresh) == tuple(want.last_refresh)


def test_round_robin_resumes_and_site_pins_like_reference():
    got, want = _pair(jax.random.key(3), refresh_every=10**6, window=None)
    x = grid(4099, seed=13)
    for svc in (got, want):
        svc.ingest(x[:2050])      # the cursor continues across calls
        svc.ingest(x[2050:])
    per_site = [tr.total_ingested for tr in got.trees]
    assert per_site == [tr.total_ingested for tr in want.trees]
    assert sum(per_site) == 4099 and max(per_site) - min(per_site) <= 1
    for svc in (got, want):
        svc.ingest(x[:7], site=2)
    assert got.trees[2].total_ingested == per_site[2] + 7
    assert_sites_equal(got, want)
    for svc in (got, want):
        with pytest.raises(ValueError, match="out of range"):
            svc.ingest(x[:1], site=4)
    with pytest.raises(ValueError, match="n_sites"):
        ShardedStreamService(ShardedServiceConfig(**{**SH, "n_sites": 0}),
                             device="cpu")


@pytest.mark.parametrize("window", [None, 3000, 3001, 4])
@pytest.mark.parametrize("site_budget", ["full", "paper"])
def test_site_tree_config_matches_reference(window, site_budget):
    kw = {**SH, "window": window, "site_budget": site_budget, "t": 30}
    got = ShardedServiceConfig(**kw)
    want = J.ShardedServiceConfig(**kw)
    assert got.site_t() == want.site_t()
    g, w = got.site_tree_config(), want.site_tree_config()
    for f in ("dim", "k", "t", "leaf_size", "metric", "window", "seed",
              "max_summaries"):
        assert getattr(g, f) == getattr(w, f), f
    assert g.summarizer.name == w.summarizer.name
    with pytest.raises(ValueError, match="site_budget"):
        ShardedServiceConfig(**{**kw, "site_budget": "half"}).site_t()


def test_windowed_sites_keep_the_reference_mass():
    """Each site's window is ceil(W/s): the trees evict as the reference's
    do, and the global mass tracks the last ~W rows."""
    got, want = _pair(jax.random.key(8), refresh_every=10**6, window=2000,
                      metric="l1")
    x = grid(9000, seed=15)
    for i in range(0, len(x), 1000):
        got.ingest(x[i:i + 1000])
        want.ingest(x[i:i + 1000])
    assert_sites_equal(got, want)
    assert got.total_weight == want.total_weight
    assert got.total_weight < 9000
    assert_models_equal(got.refresh(), want.refresh())


def _counters(reg):
    snap = reg.snapshot()["counters"]
    return (snap.get("refresh.skipped{topology=sharded}", 0),
            snap.get("refresh.warm_starts{topology=sharded}", 0))


def test_incremental_refresh_decisions_match_reference():
    """Skip on unchanged roots, warm start under warm_start_frac, cold
    refit above it: the same decisions, versions and models."""
    key = jax.random.key(9)
    kw = {**SH, "refresh_every": 10**6, "metric": "l1"}
    with obs.using_registry(obs.MetricsRegistry()) as reg, \
            tobs.using_registry(tobs.MetricsRegistry()) as treg:
        want = J.ShardedStreamService(J.ShardedServiceConfig(
            **kw, store=JStoreSpec(incremental_refresh=True,
                                   warm_start_frac=0.5)), key)
        got = ShardedStreamService(ShardedServiceConfig(
            **kw, store=StoreSpec(incremental_refresh=True,
                                  warm_start_frac=0.5)),
            JaxReplaySampler(key), device="cpu")
        x = grid(7000, seed=12)
        steps = [("ingest", x[:3600]), ("refresh",), ("refresh",),
                 ("ingest", x[3600:3800]), ("refresh",), ("refresh",),
                 ("ingest", x[3800:]), ("refresh",)]
        seen = []
        for step in steps:
            for svc in (got, want):
                if step[0] == "ingest":
                    svc.ingest(step[1])
                else:
                    svc.refresh()
            seen.append((_version(got), _version(want)))
            if got.model is not None:
                assert_models_equal(got.model, want.model)
        skipped, warm = _counters(reg)
        assert _counters(treg) == (skipped, warm)
    assert all(g == w for g, w in seen)
    assert [v for v, _ in seen] == [0, 1, 1, 1, 2, 2, 2, 3]
    assert skipped == 2 and warm == 1
    assert got._last_fit_epoch == want._last_fit_epoch


def test_tiered_sites_match_reference(tmp_path):
    """Under ``StoreSpec(hot_levels=1)`` every site spills, and the roots
    and the epoch-keyed model stay the reference's."""
    key = jax.random.key(10)
    kw = {**SH, "refresh_every": 10**6, "metric": "l1", "window": None}
    want = J.ShardedStreamService(J.ShardedServiceConfig(
        **kw, store=JStoreSpec(hot_levels=1,
                               directory=str(tmp_path / "ref"))), key)
    got = ShardedStreamService(ShardedServiceConfig(
        **kw, store=StoreSpec(hot_levels=1, directory=str(tmp_path))),
        JaxReplaySampler(key), device="cpu")
    x = grid(9000, seed=16)
    for svc in (got, want):
        svc.ingest(x)
    assert all(tr._store is not None and tr._store.spills
               for tr in got.trees)
    for g, w in zip(got.trees, want.trees):
        for a, b in zip(g.packed_root(), w.packed_root()):
            np.testing.assert_array_equal(a, b)
    assert_models_equal(got.refresh(), want.refresh())


# ------------------------------------------------------------ checkpoints
def _ingested_pair(key, x, **over):
    got, want = _pair(key, metric="l1", **over)
    for svc in (got, want):
        svc.ingest(x)
        svc.refresh()
    return got, want


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_between_packages(tmp_path, writer):
    """A checkpoint of either package's service restores in the other and
    scores, ingests and refits as the writer does, bit for bit."""
    key = jax.random.key(11)
    x = grid(5000, seed=17)
    got, want = _ingested_pair(key, x[:4000])
    cfg = dict(SH, metric="l1")
    if writer == "reference":
        want.save(JManager(tmp_path), step=1)
        restored = ShardedStreamService.restore(
            ShardedServiceConfig(**cfg), CheckpointManager(tmp_path),
            sampler_from_key_data=JaxReplaySampler.from_key_data,
            device="cpu")
        writer_svc, other = want, restored
    else:
        got.save(CheckpointManager(tmp_path), step=1)
        restored = J.ShardedStreamService.restore(
            J.ShardedServiceConfig(**cfg), JManager(tmp_path))
        writer_svc, other = got, restored
    assert JManager(tmp_path).read_meta()["format"] == "sharded-stream-v1"
    assert JManager(tmp_path).read_meta()["n_sites"] == 4
    q = grid(100, seed=18)
    assert_results_equal(other.score(q), writer_svc.score(q),
                         same_ids=False)
    for svc in (writer_svc, other):
        svc.ingest(x[4000:])
    for g, w in zip(other.trees, writer_svc.trees):
        assert_state_equal(g.pack_state(), w.pack_state())
    assert other._routed == writer_svc._routed
    a, b = other.refresh(), writer_svc.refresh()
    port_model, ref_model = (a, b) if writer == "reference" else (b, a)
    assert_models_equal(port_model, ref_model)


def test_checkpoint_guards_site_count_and_service_kind(tmp_path):
    x = grid(3000, seed=19)
    cfg = ShardedServiceConfig(**{**SH, "refresh_every": 10**6})
    svc = ShardedStreamService(cfg, device="cpu")
    svc.ingest(x)
    svc.save(CheckpointManager(tmp_path / "sharded"), step=1)
    with pytest.raises(ValueError, match="4 sites"):
        ShardedStreamService.restore(
            dataclasses.replace(cfg, n_sites=2),
            CheckpointManager(tmp_path / "sharded"), device="cpu")
    with pytest.raises(ValueError, match="4 sites"):
        J.ShardedStreamService.restore(
            J.ShardedServiceConfig(**{**SH, "n_sites": 2}),
            JManager(tmp_path / "sharded"))
    single_kw = {k: v for k, v in SH.items() if k != "n_sites"}
    with pytest.raises(ValueError, match="format"):
        StreamService.restore(ServiceConfig(**single_kw),
                              CheckpointManager(tmp_path / "sharded"),
                              device="cpu")
    single = StreamService(ServiceConfig(**single_kw), device="cpu")
    single.ingest(x)
    single.save(CheckpointManager(tmp_path / "single"), step=1)
    with pytest.raises(ValueError, match="format"):
        ShardedStreamService.restore(cfg, CheckpointManager(
            tmp_path / "single"), device="cpu")
    jsingle = J.StreamService(J.ServiceConfig(**single_kw))
    jsingle.ingest(x)
    jsingle.save(JManager(tmp_path / "jsingle"), step=1)
    with pytest.raises(ValueError, match="format"):
        ShardedStreamService.restore(cfg, CheckpointManager(
            tmp_path / "jsingle"), device="cpu")


def test_restored_service_continues_like_the_saved_one(tmp_path):
    """Under ``TorchSampler``: a save and restore in the port scores,
    ingests and refits bit for bit as the uninterrupted service."""
    cfg = ShardedServiceConfig(**{**SH, "metric": "l1"})
    svc = ShardedStreamService(cfg, TorchSampler(4), device="cpu")
    x = grid(6000, seed=20)
    svc.ingest(x[:4500])
    svc.save(CheckpointManager(tmp_path), step=3)
    back = ShardedStreamService.restore(cfg, CheckpointManager(tmp_path),
                                        device="cpu")
    q = grid(64, seed=21)
    assert_results_equal(back.score(q), svc.score(q))
    for s in (svc, back):
        s.ingest(x[4500:])
    assert_models_equal(back.refresh(), svc.refresh())


# ------------------------------------------------------------ the collective
COLLECTIVE = dict(SH, refresh_every=1024, metric="l1", use_shard_map=True)


def _collective_rank(rank, n, workdir, seed, async_refresh):
    cfg = ShardedServiceConfig(**COLLECTIVE, async_refresh=async_refresh)
    svc = ShardedStreamService(cfg, TorchSampler(seed), device="cpu")
    x = grid(6000, seed=seed)
    paths = []
    for i in range(0, len(x), 500):
        svc.ingest(x[i:i + 500])
        if svc.last_refresh is not None:
            paths.append(svc.last_refresh.path)
    svc.join_refresh()
    m = svc.refresh()
    res = svc.score(grid(128, seed=seed + 1))
    return {"paths": paths + [svc.last_refresh.path],
            "stats": tuple(svc.last_refresh),
            "model": {f: getattr(m, f).numpy() for f in m._fields},
            "results": [tuple(r)[:5] for r in res]}


@pytest.mark.parametrize("async_refresh", [False, True])
def test_collective_refresh_equals_host_sim(tmp_path, async_refresh):
    """Four ranks, each shipping its own site's root through gather_sites:
    every rank's model and drain equal the host-simulated service's bit
    for bit, and ``last_refresh.path`` says the collective ran.  An async
    collective refresh joins the one in flight instead of coalescing, so
    its versions are the blocking service's."""
    seed = 26
    ranks = spawn_ranks(_collective_rank, 4, tmp_path, seed, async_refresh)
    host = ShardedStreamService(
        ShardedServiceConfig(**COLLECTIVE, async_refresh=False),
        TorchSampler(seed), device="cpu")   # no group here: host-sim
    x = grid(6000, seed=seed)
    for i in range(0, len(x), 500):
        host.ingest(x[i:i + 500])
    host.join_refresh()
    m = host.refresh()
    res = host.score(grid(128, seed=seed + 1))
    assert host.last_refresh.path == "host-sim"
    for got in ranks:
        assert set(got["paths"]) == {"shard_map"} and len(got["paths"]) > 4
        assert got["stats"][2:] == tuple(host.last_refresh)[2:]
        assert got["stats"][0] == host.last_refresh.version
        for f in m._fields:
            np.testing.assert_array_equal(got["model"][f],
                                          getattr(m, f).numpy(), err_msg=f)
        assert got["results"] == [tuple(r)[:5] for r in res]
