"""The port's one round of communication and ``distributed_cluster`` on
``torch.distributed``, on the CPU, against the reference.

Ranks are processes started with spawn (``spawn_ranks``), joined into a
gloo group through a ``FileStore`` under ``tmp_path``; each rank writes
what it computed to a file the test reads.  The sibling ``test_torch_*``
files import ``spawn_ranks`` from here.

* ``gather_sites`` over 2 and 4 ranks equals the concatenation of every
  rank's leaves in rank order (f32, int32, bool, and a 0-d leaf);
  ``replicated_coordinator`` hands each rank its own block.
* ``payload_bytes`` / ``gathered_bytes`` give the reference's numbers for
  the same shapes and dtypes.
* The backend rule: ``nccl`` only for one rank per CUDA device, else
  ``gloo``; a rank that never joins fails within the group's timeout.
* ``distributed_cluster`` under ``JaxReplaySampler`` (the reference's
  draws) on an integer grid (``test_torch_stream.grid``: every distance
  between rows exact in f32, ROADMAP.md queue 3 item 1): with one site,
  the reference's program on a one-device mesh; with four ranks, the
  reference's own pieces composed (``_site_summarizer`` per site with
  ``fold_in(key, i)``, concatenated, then ``_second_level``), which is
  what its shard_map program computes (the program itself cannot run on
  four CPU devices under the installed jax: ROADMAP.md).  Centers, ids
  and weights bit for bit; the cost, a sum in another order, to rtol 1e-5.
"""
import os
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro.core.collective as JC
import repro.core.distributed as JD
from repro_torch.core.collective import (choose_backend, gather_sites,
                                         gathered_bytes, init_sites,
                                         payload_bytes,
                                         replicated_coordinator, sites_group)
from repro_torch.core.distributed import DistClusterResult, distributed_cluster
from test_torch_replay import JaxReplaySampler
from test_torch_stream import grid

torch.set_num_threads(1)

# a test's group: collectives fail after this long instead of hanging
TEST_TIMEOUT = timedelta(seconds=30)
FIELDS = ("centers", "outlier_ids", "summary_ids", "summary_weights",
          "comm_records", "cost")


# ------------------------------------------------------------ rank processes
def _rank_main(rank, n, workdir, fn, args):
    init_sites(rank, ["cpu"] * n, init_method=f"file://{workdir}/store",
               timeout=TEST_TIMEOUT)
    try:
        out = fn(rank, n, workdir, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def spawn_ranks(fn, n, workdir, *args):
    """Run ``fn(rank, n, workdir, *args)`` in ``n`` spawned processes, each
    a rank of a gloo group over a FileStore in ``workdir``; returns every
    rank's return value in rank order.  A rank that raises fails the
    call."""
    workdir = str(workdir)
    mp.start_processes(_rank_main, args=(n, workdir, fn, args), nprocs=n,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def _leaves_of(rank, cap=5):
    """Rank ``rank``'s payload: every dtype a summary gather moves."""
    g = np.random.default_rng(100 + rank)
    return (torch.as_tensor(g.normal(size=(cap, 3)).astype(np.float32)),
            torch.as_tensor(g.integers(-9, 9, cap).astype(np.int32)),
            torch.as_tensor(g.random(cap) < 0.5),
            torch.tensor(float(rank)))


def _gather_rank(rank, n, workdir):
    gathered = gather_sites(_leaves_of(rank))
    blocks = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    seen = replicated_coordinator(
        lambda xp, tag: (xp.copy(), tag), n_sharded=1)(blocks, "replicated")
    return {"gathered": [a.numpy() for a in gathered],
            "block": seen[0], "tag": seen[1],
            "group_ok": sites_group(n) is not None
            and sites_group(n + 1) is None}


def _cluster_rank(rank, n, workdir, key_words, kw):
    x_parts = np.load(os.path.join(workdir, "x.npy"), mmap_mode="r")
    res = distributed_cluster(x_parts, JaxReplaySampler.from_key_data(
        np.asarray(key_words, np.uint32)), **kw, device="cpu")
    return {f: getattr(res, f).numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return spawn_ranks(_gather_rank, 2, tmp_path_factory.mktemp("ranks2"))


# the 4-rank cluster: 4 sites of 600 grid rows, k = 4, t = 20 (t_i = 10)
CLUSTER = dict(k=4, t=20, second_iters=10)
CLUSTER_KEY = jax.random.key(21)


def _cluster_parts():
    return grid(2400, seed=22).reshape(4, 600, 4)


def _gather_then_cluster(rank, n, workdir, key_words, kw):
    return {**_gather_rank(rank, n, workdir),
            **_cluster_rank(rank, n, workdir, key_words, kw)}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ranks4")
    np.save(workdir / "x.npy", _cluster_parts())
    words = np.asarray(jax.random.key_data(CLUSTER_KEY)).tolist()
    return spawn_ranks(_gather_then_cluster, 4, workdir, words, CLUSTER)


# ------------------------------------------------------------ the collective
@pytest.mark.parametrize("n", [2, 4])
def test_gather_sites_concatenates_in_rank_order(n, request):
    ranks = request.getfixturevalue(f"ranks{n}")
    want = [np.concatenate([np.atleast_1d(_leaves_of(r)[i].numpy())
                            for r in range(n)]) for i in range(4)]
    for got in ranks:
        assert got["group_ok"]
        for g, w in zip(got["gathered"], want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert want[0].shape == (5 * n, 3) and want[3].shape == (n,)


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_coordinator_hands_each_rank_its_block(n, request):
    ranks = request.getfixturevalue(f"ranks{n}")
    blocks = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["block"], blocks[r:r + 1])
        assert got["tag"] == "replicated"


PAYLOADS = {   # (shape, dtype) of each leaf
    "summary": [((7, 34), np.float32), ((7,), np.float32), ((7,), np.bool_),
                ((7,), np.int32)],
    "root": [((256, 5), np.float32), ((256,), np.float32),
             ((256,), np.bool_)],
    "scalars": [((), np.float32), ((3, 2, 2), np.uint8)],
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_payload_and_gathered_bytes_match_reference(name):
    arrays = tuple(np.zeros(s, d) for s, d in PAYLOADS[name])
    want = JC.payload_bytes(tuple(jnp.asarray(a) for a in arrays))
    assert payload_bytes(arrays) == want
    assert payload_bytes(tuple(torch.as_tensor(a) for a in arrays)) == want
    assert payload_bytes({"a": list(arrays)}) == want
    for s in (1, 4, 20):
        assert gathered_bytes(arrays, s) == JC.gathered_bytes(
            tuple(jnp.asarray(a) for a in arrays), s)


@pytest.mark.parametrize("devices,backend", [
    (["cpu"], "gloo"),
    (["cpu"] * 4, "gloo"),
    (["cuda:0"] * 4, "gloo"),          # ranks sharing one card
    (["cuda", "cuda:0"], "gloo"),      # an index-less cuda is cuda:0
    (["cuda:0", "cpu"], "gloo"),
    (["cuda:0"], "nccl"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl"),
])
def test_backend_rule(devices, backend):
    assert choose_backend(devices) == backend


def test_backend_rule_needs_a_device_per_rank():
    with pytest.raises(ValueError, match="one device per rank"):
        choose_backend([])


def _lonely_rank(workdir):
    init_sites(0, ["cpu", "cpu"], init_method=f"file://{workdir}/store",
               timeout=timedelta(seconds=2))


def test_rank_that_never_joins_fails_within_its_timeout(tmp_path):
    """Rank 0 of a 2-rank group whose rank 1 never arrives: setup raises
    after the timeout, the process exits non-zero, nothing hangs."""
    ctx = mp.get_context("spawn")
    proc = ctx.Process(target=_lonely_rank, args=(str(tmp_path),))
    proc.start()
    proc.join(timeout=50)
    alive = proc.is_alive()
    if alive:
        proc.kill()
        proc.join()
    assert not alive and proc.exitcode not in (0, None)


# ------------------------------------------------------------ distributed_cluster
@pytest.fixture
def one_rank(tmp_path):
    """This process as the single rank of a gloo group."""
    init_sites(0, ["cpu"], init_method=f"file://{tmp_path}/store",
               timeout=TEST_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _reference_pieces(x_parts, key, *, k, t, second_iters, metric="l2sq"):
    """The reference's shard_map program, composed from its own pieces."""
    s, n_per, _ = x_parts.shape
    summarize = JD._site_summarizer(None, "augmented", metric=metric, k=k,
                                    t=JD.local_budget(t, s, "random"))
    pts, wts, val, gid = [], [], [], []
    for i in range(s):
        summ = summarize(jnp.asarray(x_parts[i]), jax.random.fold_in(key, i),
                         policy=None)
        pts.append(summ.points)
        wts.append(summ.weights)
        val.append(summ.valid)
        gid.append(jnp.where(summ.valid, summ.indices + i * n_per, -1))
    pts, wts, val, gid = (jnp.concatenate(a) for a in (pts, wts, val, gid))
    sol, out_ids, _ = JD._second_level(
        pts, wts, val, gid, jax.random.fold_in(key, 2**31 - 1), k=k, t=t,
        iters=second_iters, metric=metric, policy=None)
    return {"centers": sol.centers, "outlier_ids": out_ids,
            "summary_ids": gid, "summary_weights": wts,
            "comm_records": val.sum().astype(jnp.float32), "cost": sol.cost}


def assert_cluster_equal(got: dict, want: dict):
    """Everything bit for bit but the cost (rtol 1e-5)."""
    for f in FIELDS[:-1]:
        w = np.asarray(want[f])
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    np.testing.assert_allclose(got["cost"], np.asarray(want["cost"]),
                               rtol=1e-5)


def test_one_site_matches_reference_mesh(one_rank):
    x = grid(2400, seed=23)
    key = jax.random.key(24)
    want = JD.distributed_cluster(jnp.asarray(x)[None], key,
                                  JC.sites_mesh(1), k=4, t=20,
                                  second_iters=10)
    res = distributed_cluster(x[None], JaxReplaySampler(key), k=4, t=20,
                              second_iters=10, device="cpu")
    assert isinstance(res, DistClusterResult)
    assert set(res.phase_s) == {"site_summary", "gather", "second_level"}
    assert_cluster_equal({f: getattr(res, f).numpy() for f in FIELDS},
                         want._asdict())


def test_four_ranks_match_reference_pieces(ranks4):
    want = _reference_pieces(_cluster_parts(), CLUSTER_KEY, **CLUSTER)
    assert float(want["comm_records"]) > 0
    for got in ranks4:
        assert_cluster_equal(got, want)


def test_every_rank_returns_the_same_result(ranks4):
    for got in ranks4[1:]:
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], ranks4[0][f], err_msg=f)


def test_outlier_ids_flagged_first_in_stable_order(ranks4):
    """``outlier_ids`` are the flagged records' global ids in gathered
    order, then -1: a stable argsort of ~outlier (``torch.argsort`` is
    not stable unless asked)."""
    got = ranks4[0]
    out = got["outlier_ids"]
    n_out = int((out >= 0).sum())
    assert 0 < n_out < out.size
    assert (out[:n_out] >= 0).all() and (out[n_out:] == -1).all()
    sid = got["summary_ids"]
    flagged = np.isin(sid, out[:n_out]) & (sid >= 0)
    np.testing.assert_array_equal(out[:n_out], sid[flagged])
    # mass per site: every site's weights sum to its 600 rows
    w = got["summary_weights"].reshape(4, -1)
    np.testing.assert_array_equal(w.sum(1), np.full(4, 600, np.float32))
    assert got["comm_records"] == float((sid >= 0).sum())


def test_distributed_cluster_refuses_bad_inputs(one_rank):
    x = grid(400, seed=25)
    from repro_torch.summarize import summarizer_policy
    with pytest.raises(ValueError, match="no fixed-shape site path"):
        distributed_cluster(x[None], JaxReplaySampler(jax.random.key(0)),
                            k=4, t=10,
                            summarizer=summarizer_policy("ball_cover"),
                            device="cpu")
    with pytest.raises(ValueError, match="the group has 1 sites"):
        distributed_cluster(x.reshape(2, 200, 4),
                            JaxReplaySampler(jax.random.key(0)), k=4, t=10,
                            device="cpu")
    with pytest.raises(ValueError, match="summary_alg"):
        distributed_cluster(x[None], JaxReplaySampler(jax.random.key(0)),
                            k=4, t=10, summary_alg="compact", device="cpu")
