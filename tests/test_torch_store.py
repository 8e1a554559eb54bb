"""The port's tiered summary store, on the CPU, against the reference.

Mirrors the reference's ``tests/test_store.py`` for what the port has
(``StoreSpec`` validation, spill and page-in under a level or byte budget,
metadata of spilled nodes, eviction deleting blobs, the service under a
tiered store and its checkpoint).  The store moves bytes only: a tiered
tree's packed root is bit for bit the all-resident tree's, and under
``JaxReplaySampler`` a tiered port tree packs the reference's tiered
tree's state leaf for leaf.  Data: the reference's drifting stream, and
the integer grid of ``tests/test_torch_stream.py`` where the port is held
to the reference bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import repro.store as JS
import repro.stream as J
from repro_torch import obs as tobs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import drifting_gauss
from repro_torch.store import StoreSpec, summary_nbytes
from repro_torch.stream import (ServiceConfig, StreamService, StreamTree,
                                TreeConfig)
from test_torch_replay import JaxReplaySampler
from test_torch_stream import assert_results_equal, assert_state_equal, grid

torch.set_num_threads(1)


def _drift(n, d=4, seed=0):
    """First `n` points of a 3-phase drifting mixture (seeded, float32)."""
    per = -(-n // (3 * 6))
    x, _, _ = drifting_gauss(n_phases=3, n_centers=6, per_center=per,
                             d=d, sigma=0.05, drift=4.0, seed=seed)
    return np.asarray(x[:n], np.float32)


def _cold(tree):
    return [nd for nd in tree.nodes if nd.summary is None]


def test_storespec_validation():
    assert not StoreSpec().tiered
    assert StoreSpec(hot_levels=0).tiered
    assert StoreSpec(hot_bytes=1 << 20).tiered
    for bad, match in (({"hot_levels": -1}, "hot_levels"),
                       ({"hot_levels": True}, "hot_levels"),
                       ({"hot_bytes": 0}, "hot_bytes"),
                       ({"warm_start_frac": 1.5}, "warm_start_frac"),
                       ({"incremental_refresh": "yes"},
                        "incremental_refresh"),
                       ({"directory": 7}, "directory")):
        with pytest.raises(ValueError, match=match):
            StoreSpec(**bad)
    assert StoreSpec(warm_start_frac=1).warm_start_frac == 1.0


def _tree_pair(spec, *, n=40_000, window=8192, leaf_size=512, seed=0):
    """Ingest the same drifting stream into an untiered and a tiered tree."""
    base = dict(dim=4, k=6, t=24, leaf_size=leaf_size, window=window,
                seed=3)
    plain = StreamTree(TreeConfig(**base), device="cpu")
    tiered = StreamTree(TreeConfig(**base, store=spec), device="cpu")
    x = _drift(n, seed=seed)
    for i in range(0, len(x), 4096):
        plain.ingest(x[i:i + 4096])
        tiered.ingest(x[i:i + 4096])
    return plain, tiered


@pytest.mark.parametrize("hot_levels", [0, 1])
def test_tiered_root_bit_identical_under_level_budget(hot_levels):
    plain, tiered = _tree_pair(StoreSpec(hot_levels=hot_levels))
    assert len(_cold(tiered)) >= 1
    # the root gather pages the cold levels in (a merge of two may have)
    for a, b in zip(plain.packed_root(), tiered.packed_root()):
        np.testing.assert_array_equal(a, b)
    st = tiered.store.stats()
    assert st["spills"] >= 1 and st["page_ins"] >= 1
    assert st["spill_bytes"] > 0 and st["page_in_bytes"] > 0
    assert plain.total_weight == tiered.total_weight
    assert plain.num_records == tiered.num_records
    assert_state_equal(tiered.pack_state(), plain.pack_state())


def test_tiered_byte_budget_bounds_resident_payload():
    budget = 8 * 1024
    plain, tiered = _tree_pair(StoreSpec(hot_bytes=budget))
    resident = sum(nd.nbytes for nd in tiered.nodes
                   if nd.summary is not None)
    assert resident <= budget
    assert tiered.store.stats()["spills"] >= 1
    for a, b in zip(plain.packed_root(), tiered.packed_root()):
        np.testing.assert_array_equal(a, b)


def test_spilled_nodes_metadata_survives():
    _, tiered = _tree_pair(StoreSpec(hot_levels=0))
    for nd in _cold(tiered):
        assert nd.spill_step is not None
        assert nd.n_records > 0 and nd.nbytes > 0 and nd.weight > 0
    # page_in is transient: reading a cold node does not re-residentize
    nd = _cold(tiered)[0]
    summ = tiered.store.page_in(nd)
    assert summ.points.shape[0] == nd.n_records
    assert summ.points.device == tiered.device
    assert summary_nbytes(summ) == nd.nbytes
    assert nd.summary is None


def test_eviction_discards_spilled_files():
    cfg = TreeConfig(dim=4, k=6, t=24, leaf_size=256, window=2048, seed=3,
                     store=StoreSpec(hot_levels=0))
    tree = StreamTree(cfg, device="cpu")
    x = _drift(30_000, seed=1)
    for i in range(0, len(x), 1024):
        tree.ingest(x[i:i + 1024])
    store = tree.store
    store.flush()
    on_disk = store.manager.all_steps()
    assert on_disk == sorted(nd.spill_step for nd in _cold(tree))
    assert len(on_disk) < store.stats()["spills"]
    store.close()
    assert not store.dir.exists()


def test_tiered_tree_matches_reference_under_replay(tmp_path):
    """Spilled levels in both packages: the same state, leaf for leaf, and
    the same count of spilled nodes and byte sizes."""
    kw = dict(dim=4, k=4, t=12, leaf_size=256, window=2048, seed=2)
    key = jax.random.key(13)
    want = J.StreamTree(J.TreeConfig(
        **kw, store=JS.StoreSpec(hot_levels=0,
                                 directory=str(tmp_path / "j"))), key)
    got = StreamTree(TreeConfig(
        **kw, store=StoreSpec(hot_levels=0, directory=str(tmp_path / "p"))),
        JaxReplaySampler(key), device="cpu")
    x = grid(6000, seed=5)
    for i in range(0, len(x), 900):
        want.ingest(x[i:i + 900])
        got.ingest(x[i:i + 900])
    assert got.store.stats() == want.store.stats()
    assert [nd.nbytes for nd in got.nodes] == [nd.nbytes for nd in want.nodes]
    assert [nd.spill_step is None for nd in got.nodes] == \
        [nd.spill_step is None for nd in want.nodes]
    assert_state_equal(got.pack_state(), want.pack_state())


# ------------------------------------------------------------ service
def _svc_cfg(**over):
    base = dict(dim=4, k=5, t=20, leaf_size=512, refresh_every=4096,
                window=8192, seed=7)
    base.update(over)
    return ServiceConfig(**base)


def test_service_scores_bit_identical_tiered_vs_untiered():
    x = _drift(24_000, seed=2)
    q = _drift(256, seed=9)
    plain = StreamService(_svc_cfg(store=StoreSpec()), device="cpu")
    tiered = StreamService(_svc_cfg(store=StoreSpec(hot_levels=0)),
                           device="cpu")
    for i in range(0, len(x), 2048):
        plain.ingest(x[i:i + 2048])
        tiered.ingest(x[i:i + 2048])
    for a, b in zip(plain.tree.packed_root(), tiered.tree.packed_root()):
        np.testing.assert_array_equal(a, b)
    assert_results_equal(tiered.score(q), plain.score(q))


def test_service_checkpoint_roundtrip_with_spilled_levels(tmp_path):
    cfg = _svc_cfg(store=StoreSpec(hot_levels=0))
    svc = StreamService(cfg, device="cpu")
    x = _drift(24_000, seed=4)
    for i in range(0, len(x), 2048):
        svc.ingest(x[i:i + 2048])
    assert len(_cold(svc.tree)) >= 1   # checkpoint must pack cold levels
    q = _drift(256, seed=11)
    before = svc.score(q)
    svc.save(CheckpointManager(tmp_path), step=1)
    restored = StreamService.restore(cfg, CheckpointManager(tmp_path),
                                     device="cpu")
    assert len(_cold(restored.tree)) >= 1   # re-tiered in a fresh directory
    assert restored.tree.store.dir != svc.tree.store.dir
    for a, b in zip(svc.tree.packed_root(), restored.tree.packed_root()):
        np.testing.assert_array_equal(a, b)
    assert_results_equal(restored.score(q), before, same_ids=False)
    restored.ingest(x[:2048])
    assert restored.tree.total_ingested == svc.tree.total_ingested + 2048


def test_incremental_refresh_skips_and_scores_like_always_refit():
    x = _drift(20_000, seed=6)
    q = _drift(256, seed=13)
    skip = StreamService(_svc_cfg(
        store=StoreSpec(hot_levels=0, incremental_refresh=True)),
        device="cpu")
    refit = StreamService(_svc_cfg(
        store=StoreSpec(hot_levels=0, incremental_refresh=False)),
        device="cpu")
    for i in range(0, len(x), 2048):
        skip.ingest(x[i:i + 2048])
        refit.ingest(x[i:i + 2048])
    regs = {}
    for svc in (skip, refit):   # each service's refresh counters apart
        with tobs.using_registry(tobs.MetricsRegistry()) as regs[svc]:
            for _ in range(2):
                svc.refresh(blocking=True)
    assert int(refit.model.version) > int(skip.model.version)

    def skipped(svc):
        return regs[svc].snapshot()["counters"].get(
            "refresh.skipped{topology=stream}", 0)

    assert skipped(skip) >= 1 and skipped(refit) == 0
    assert_results_equal(skip.score(q), refit.score(q), same_ids=False)


def test_warm_start_counter_and_validity():
    with tobs.using_registry(tobs.MetricsRegistry()) as reg:
        svc = StreamService(_svc_cfg(refresh_every=100_000,
                                     store=StoreSpec(warm_start_frac=1.0)),
                            device="cpu")
        x = _drift(16_000, seed=8)
        svc.ingest(x[:12_000])
        svc.refresh(blocking=True)
        v = int(svc.model.version)
        svc.ingest(x[12_000:])   # small new mass -> warm-startable
        svc.refresh(blocking=True)
    assert int(svc.model.version) == v + 1
    assert reg.snapshot()["counters"][
        "refresh.warm_starts{topology=stream}"] >= 1
    assert torch.isfinite(svc.model.centers).all()


def test_store_refuses_cuda_without_a_card(monkeypatch):
    from repro_torch.store import TieredStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TieredStore(StoreSpec(hot_levels=0), dim=4)
