"""The port's stream tree and stream service against the reference, on the
CPU.

Under ``JaxReplaySampler`` (the reference's draws) the port's
``StreamTree`` must pack the reference's state leaf for leaf, bit for bit
(``key_data`` included), and the port's ``StreamService`` must refresh on
the reference's cadence, to the reference's versions, centers and
threshold bit for bit, and drain the reference's results.  The data is
an integer grid (``grid``): every distance between two of its rows is
exact in f32 whatever order a sum runs in, so the summaries cannot part on
an ulp (ROADMAP.md, queue 3 item 1), and a Lloyd sum is exact.  The
centers k-means-- fits are means, not grid points: an l2sq distance to
them is a dot product that XLA's CPU dot and torch sum in other orders
(ROADMAP.md, queue 3 item 4).  So the service runs under l1 (no dot
product) where its threshold and drained results are held bit for bit,
and under l2sq the threshold is held to 1e-6 of the expansion's magnitude
and the drained distances and scores to rtol 1e-5.  The cost, a sum in
another order, is held to rtol 1e-5.  Under ``TorchSampler`` the sampler
packs into two words and a restored sampler draws what the original
draws.
"""
import jax
import numpy as np
import pytest
import torch

import repro.stream as J
from repro import obs
from repro_torch import obs as tobs
from repro.store import StoreSpec as JStoreSpec
from repro_torch.core.sampler import TorchSampler
from repro_torch.store import StoreSpec
from repro_torch.stream import (ServiceConfig, StreamService, StreamTree,
                                TreeConfig, record_cap)
from repro_torch.stream.service import LATENCY_RING
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)


def grid(n, d=4, seed=0, k=4, far=8):
    """``n`` rows on an integer grid: ``k`` blobs of +-3 around integer
    centers in [-40, 40]^d, ``far`` of them moved by up to +-60."""
    rng = np.random.default_rng(seed)
    cen = rng.integers(-40, 41, size=(k, d))
    x = cen[rng.integers(0, k, n)] + rng.integers(-3, 4, size=(n, d))
    ids = rng.choice(n, far, replace=False)
    x[ids] += rng.integers(-60, 61, size=(far, d))
    return x.astype(np.float32)


def assert_state_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        g = np.asarray(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def assert_results_equal(got, want, *, exact=True, same_ids=True):
    """Drained results: ids (unless ``same_ids=False``), centers and flags
    equal; distances and scores bit for bit, or (``exact=False``, l2sq)
    within the port's f32 distance tolerance, rtol 1e-5 (ROADMAP.md, north
    star)."""
    assert len(got) == len(want)
    if same_ids:
        assert [r.request_id for r in got] == [r.request_id for r in want]
    assert [r.center for r in got] == [r.center for r in want]
    assert [r.is_outlier for r in got] == [r.is_outlier for r in want]
    for name in ("distance", "outlier_score"):
        g = np.array([getattr(r, name) for r in got], np.float32)
        w = np.array([getattr(r, name) for r in want], np.float32)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)


def assert_models_equal(got, want, root=None):
    """Centers, version and trained mass bit for bit (on the grid a Lloyd
    sum is exact, and the mean is one rounding of it); the threshold bit
    for bit, or, given the l2sq ``root`` it was fit on, within 1e-6 of the
    magnitude the expansion x2 + c2 - 2 x.c works at (a distance to a
    fitted center is a dot product summed in another order); the cost, a
    sum over the root in another order, to rtol 1e-5 (as
    ``tests/test_torch_oneshot.py`` holds it)."""
    for name in ("centers", "version", "trained_weight"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    g, w = float(got.threshold), float(want.threshold)
    if root is None:
        assert g == w, (g, w)
    else:
        c = np.asarray(want.centers, np.float64)
        scale = (np.asarray(root, np.float64) ** 2).sum(1).max() + \
            (c ** 2).sum(1).max()
        assert abs(g - w) <= 1e-6 * scale, (g, w, scale)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)


# ------------------------------------------------------------------ tree
TREE_CASES = {
    "plain": dict(),
    "windowed": dict(window=1536),
    "merges": dict(max_summaries=3),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_pack_state_matches_reference(case):
    kw = dict(dim=4, k=4, t=12, leaf_size=256, seed=2, **TREE_CASES[case])
    key = jax.random.key(11)
    want = J.StreamTree(J.TreeConfig(**kw), key)
    got = StreamTree(TreeConfig(**kw), JaxReplaySampler(key), device="cpu")
    x = grid(4000, seed=1)
    for i in range(0, len(x), 700):
        want.ingest(x[i:i + 700])
        got.ingest(x[i:i + 700])
    assert [nd.level for nd in got.nodes] == [nd.level for nd in want.nodes]
    assert got.root_epoch == want.root_epoch
    assert got.level_epochs() == want.level_epochs()
    assert got.num_records == want.num_records
    if case == "merges":
        assert len(got.nodes) <= 3
    assert_state_equal(got.pack_state(), want.pack_state())
    for a, b in zip(got.packed_root(), want.packed_root()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [None, 1024, 4096, 50_000])
@pytest.mark.parametrize("max_summaries", [4, 64])
def test_record_cap_matches_reference(window, max_summaries):
    for k, t, leaf in ((6, 12, 256), (20, 10_000, 2048), (3, 1, 64)):
        kw = dict(dim=3, k=k, t=t, leaf_size=leaf, window=window,
                  max_summaries=max_summaries)
        assert record_cap(TreeConfig(**kw)) == J.record_cap(
            J.TreeConfig(**kw))


def test_tree_skeleton_is_the_reference_layout():
    kw = dict(dim=4, k=4, t=12, leaf_size=256, window=2048)
    got = StreamTree.skeleton_state(TreeConfig(**kw))
    want = J.StreamTree.skeleton_state(J.TreeConfig(**kw))
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape and got[name].dtype == w.dtype


def test_tree_restored_from_reference_state_continues_like_it():
    kw = dict(dim=4, k=4, t=12, leaf_size=256, window=2048, seed=2)
    key = jax.random.key(4)
    want = J.StreamTree(J.TreeConfig(**kw), key)
    x = grid(5000, seed=3)
    want.ingest(x[:2600])
    got = StreamTree.from_state(
        TreeConfig(**kw), want.pack_state(),
        sampler_from_key_data=JaxReplaySampler.from_key_data, device="cpu")
    assert_state_equal(got.pack_state(), want.pack_state())
    want.ingest(x[2600:])
    got.ingest(x[2600:])
    assert_state_equal(got.pack_state(), want.pack_state())


def test_tree_rejects_mismatched_weights():
    tree = StreamTree(TreeConfig(dim=3, k=5, t=10, leaf_size=256),
                      device="cpu")
    with pytest.raises(ValueError):
        tree.ingest(grid(10, 3), np.ones(20))   # silent truncation risk
    with pytest.raises(ValueError):
        tree.ingest(grid(10, 3), np.ones(4))
    assert tree.total_ingested == 0


# ------------------------------------------------------------------ service
SVC = dict(dim=4, k=4, t=12, leaf_size=256, refresh_every=1500,
           micro_batch=64, window=3000, seed=5)


def _pair(key, **over):
    kw = {**SVC, **over}
    want = J.StreamService(J.ServiceConfig(**kw), key)
    got = StreamService(ServiceConfig(**kw), JaxReplaySampler(key),
                        device="cpu")
    return got, want


def _version(svc):
    return 0 if svc.model is None else int(svc.model.version)


@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_service_matches_reference(metric):
    got, want = _pair(jax.random.key(5), metric=metric)
    x = grid(6000, seed=0)
    versions = []
    for i in range(0, len(x), 700):
        want.ingest(x[i:i + 700])
        got.ingest(x[i:i + 700])
        versions.append((_version(got), _version(want)))
    assert all(g == w for g, w in versions) and versions[-1][0] >= 3
    assert got._since_refresh == want._since_refresh
    assert_state_equal(got.tree.pack_state(), want.tree.pack_state())
    root = None if metric == "l1" else want.tree.root()[0]
    assert_models_equal(got.model, want.model, root)
    q = grid(200, seed=9)
    assert_results_equal(got.score(q), want.score(q),
                         exact=metric == "l1")
    # a blocking refresh on demand: same version and model again
    assert_models_equal(got.refresh(), want.refresh(), root)


def test_service_async_refresh_matches_blocking():
    """The fit is a pure function of (root snapshot, version, sampler): the
    async model is the blocking one, and the reference's."""
    x = grid(3000, seed=30)
    kw = dict(refresh_every=10**6, metric="l1")
    key = jax.random.key(7)
    blocking, want = _pair(key, **kw)
    async_ = StreamService(ServiceConfig(**{**SVC, **kw}, async_refresh=True),
                           JaxReplaySampler(key), device="cpu")
    for svc in (blocking, want, async_):
        svc.ingest(x)
    m_sync = blocking.refresh()
    async_.refresh(blocking=False)
    assert async_.refresh_in_flight or async_.model is not None
    async_.join_refresh()
    assert not async_.refresh_in_flight
    assert int(async_.model.version) == int(m_sync.version) == 1
    assert_models_equal(async_.model, m_sync)
    assert_models_equal(async_.model, want.refresh())


def test_service_async_cadence_coalesces_and_serves():
    """Cadence refreshes under async_refresh never block ingest and
    coalesce while a fit is in flight; drain() waits for the first model
    instead of failing (the reference's test of the same name)."""
    x = grid(4096, d=3, seed=31)
    kw = dict(dim=3, k=4, t=10, leaf_size=256, refresh_every=1024, seed=8,
              async_refresh=True)
    svc = StreamService(ServiceConfig(**{**SVC, **kw}), device="cpu")
    svc.ingest(x)
    res = svc.score(x[:32])          # drain joins the first in-flight fit
    assert len(res) == 32
    svc.join_refresh()
    assert int(svc.model.version) >= 1 and not svc.refresh_in_flight
    v = int(svc.model.version)
    assert int(svc.refresh().version) == v + 1


def test_service_async_snapshot_error_raises_on_caller():
    svc = StreamService(ServiceConfig(**{**SVC, "async_refresh": True}),
                        device="cpu")
    with pytest.raises(RuntimeError, match="before any point"):
        svc.refresh(blocking=False)   # the snapshot happens on the caller


def _counters(reg):
    snap = reg.snapshot()["counters"]
    return (snap.get("refresh.skipped{topology=stream}", 0),
            snap.get("refresh.warm_starts{topology=stream}", 0))


def test_incremental_refresh_decisions_match_reference():
    """Skip on an unchanged root, warm start under warm_start_frac, cold
    refit above it: the same decisions, versions and models."""
    key = jax.random.key(9)
    kw = dict(refresh_every=10**6, metric="l1")
    with obs.using_registry(obs.MetricsRegistry()) as reg, \
            tobs.using_registry(tobs.MetricsRegistry()) as treg:
        want = J.StreamService(J.ServiceConfig(
            **{**SVC, **kw}, store=JStoreSpec(incremental_refresh=True,
                                          warm_start_frac=0.5)), key)
        got = StreamService(ServiceConfig(
            **{**SVC, **kw}, store=StoreSpec(incremental_refresh=True,
                                         warm_start_frac=0.5)),
            JaxReplaySampler(key), device="cpu")
        x = grid(6000, seed=12)
        steps = [("ingest", x[:2800]), ("refresh",), ("refresh",),
                 ("ingest", x[2800:3000]), ("refresh",), ("refresh",),
                 ("ingest", x[3000:]), ("refresh",)]
        seen = []
        for step in steps:
            for svc in (got, want):
                if step[0] == "ingest":
                    svc.ingest(step[1])
                else:
                    svc.refresh()
            seen.append((_version(got), _version(want)))
            assert_models_equal(got.model, want.model) if got.model else None
        skipped, warm = _counters(reg)
        assert _counters(treg) == (skipped, warm)
    assert all(g == w for g, w in seen)
    assert [v for v, _ in seen] == [0, 1, 1, 1, 2, 2, 2, 3]
    assert skipped == 2 and warm == 1


def test_discard_pending_and_block_split_match_reference():
    got, want = _pair(jax.random.key(3), metric="l1")
    x = grid(3000, seed=14)
    got.ingest(x)
    want.ingest(x)
    q = grid(300, seed=15)
    out = {}
    for name, svc in (("got", got), ("want", want)):
        ids = [svc.submit(q[:50]), svc.submit(q[50:150]),
               svc.submit(q[150:180])]
        first = svc.drain(max_requests=90)      # splits the second block
        second = svc.drain(max_requests=40)
        dropped = svc.discard_pending()
        after = svc.score(q[180:300])           # a fresh block, 2 batches
        out[name] = (ids, first, second, dropped, after)
        assert [r.request_id for r in first + second] == \
            ids[0] + ids[1][:80]
        assert dropped == 50 and svc.drain() == []
    for a, b in zip(out["got"], out["want"]):
        if isinstance(a, list) and a and hasattr(a[0], "center"):
            assert_results_equal(a, b)
        else:
            assert a == b


def test_latency_ring_is_bounded_with_exact_percentiles():
    """``latency_stats`` reads the ``serve.latency`` histogram: its count
    covers every request, its percentiles the ring's last
    ``LATENCY_RING``."""
    with tobs.using_registry(tobs.MetricsRegistry()):
        svc = StreamService(ServiceConfig(**SVC), device="cpu")
    svc.ingest(grid(1600, seed=16))
    q = grid(SVC["micro_batch"], seed=17)
    for _ in range(LATENCY_RING // SVC["micro_batch"] + 3):
        svc.score(q)
    st = svc.latency_stats()
    ring = np.asarray(svc._lat._ring, np.float64)
    assert ring.shape == (LATENCY_RING,)
    assert st["count"] == (LATENCY_RING // SVC["micro_batch"] + 3) * 64
    assert st["p50_ms"] == float(np.percentile(ring, 50)) * 1e3
    assert st["p99_ms"] == float(np.percentile(ring, 99)) * 1e3
    svc.reset_latency_stats()
    assert svc.latency_stats()["count"] == 0


def test_service_scores_planted_far_rows_as_outliers():
    svc = StreamService(ServiceConfig(**SVC), device="cpu")
    x = grid(4000, seed=18)
    svc.ingest(x)
    res = svc.score(np.full((1, 4), 500.0, np.float32))[0]
    assert res.is_outlier and res.outlier_score > 10
    assert svc.last_fit.version == int(svc.model.version)
    assert svc.last_fit.records_folded > 0 and svc.last_fit.fit_s >= 0
    assert svc.seconds_since_install() >= 0
    with pytest.raises(ValueError):
        svc.submit(np.zeros((2, 3), np.float32))   # dim is 4


# ------------------------------------------------------------------ sampler
def test_torch_sampler_packs_into_two_words_after_a_long_chain():
    s = TorchSampler(123)
    for i in range(1000):
        s = s.split(2)[i % 2]
    s = s.fold_in(2**31 - 1)
    words = s.key_data()
    assert words.dtype == np.uint32 and words.shape == (2,)
    r = TorchSampler.from_key_data(words)
    np.testing.assert_array_equal(r.key_data(), words)
    logits = torch.where(torch.arange(300) % 3 == 0, 0.0, float("-inf"))
    assert torch.equal(r.categorical(logits, (50,)),
                       s.categorical(logits, (50,)))
    assert torch.equal(r.randint(97, (40,)), s.randint(97, (40,)))
    assert torch.equal(r.uniform((40,), 0.0, 1.0), s.uniform((40,), 0.0, 1.0))
    assert torch.equal(r.choice(90, (30,)), s.choice(90, (30,)))
    for a, b in zip(r.split(3), s.split(3)):
        np.testing.assert_array_equal(a.key_data(), b.key_data())
    assert not np.array_equal(s.split(2)[0].key_data(),
                              s.split(2)[1].key_data())
    assert not np.array_equal(s.fold_in(1).key_data(),
                              s.fold_in(2).key_data())
    with pytest.raises(ValueError, match="2 uint32"):
        TorchSampler.from_key_data(np.zeros((3,), np.uint32))


def test_replay_sampler_key_data_is_the_jax_key():
    key = jax.random.fold_in(jax.random.key(5), 3)
    s = JaxReplaySampler(key)
    np.testing.assert_array_equal(s.key_data(),
                                  np.asarray(jax.random.key_data(key)))
    r = JaxReplaySampler.from_key_data(s.key_data())
    np.testing.assert_array_equal(r.randint(50, (9,)).numpy(),
                                  s.randint(50, (9,)).numpy())


# ------------------------------------------------------------------ device
def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServiceConfig(**SVC)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamService(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamTree(cfg.tree_config())
    with pytest.raises(RuntimeError, match="cuda"):
        StreamTree.from_state(cfg.tree_config(),
                              StreamTree.skeleton_state(cfg.tree_config()))
