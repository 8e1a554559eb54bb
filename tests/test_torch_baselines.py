"""The paper's baselines (`rand`, k-means||) and Algorithm 3 with each
registered summarizer, against the reference, on the CPU.

Under ``JaxReplaySampler`` the port must give the reference's ids,
weights, sigma and communication for ``rand_summary`` and
``kmeans_parallel_summary``, and for ``simulate_coordinator(summarizer=)``
/ ``_run_oneshot(summarizer=)`` its summary and outlier ids, candidate
flags and ``comm_records`` equal, integer-valued weights equal (the
``coreset`` weights within rtol 1e-6), centers within 1e-5 and the cost
within rtol 1e-5.  Data: ``examples/oneshot.json``'s gauss 5x400, d = 5,
k = 5, t = 25 over 4 sites, as ``tests/test_torch_oneshot.py``; the
``coreset`` run and the baselines' normal cloud on an integer grid, where
every distance is exact whatever order a dot product sums in (with float
data the XLA-CPU dot and torch's part them: ROADMAP.md, queue 3, item 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.summarize as jsum
from repro.api.config import pipeline_config
from repro.api.session import _run_oneshot as jax_run_oneshot
from repro_torch.api.config import pipeline_config as torch_pipeline_config
from repro.core.distributed import simulate_coordinator as jax_simulate
from repro.core.kmeans_parallel import kmeans_parallel_summary as jax_kpar
from repro.core.rand_summary import rand_summary as jax_rand
from repro_torch.api.session import _run_oneshot
from repro_torch.core import kmeans_parallel_summary, rand_summary
from repro_torch.core.distributed import local_budget, simulate_coordinator
from repro_torch.core.kmeans_parallel import comm_records
from repro_torch.core.sampler import TorchSampler
from repro_torch.data.synthetic import gauss
from repro_torch.summarize import summarizer_policy
from repro_torch.summarize.uniform import reservoir_ids
from repro_torch.stream.weighted import max_rounds
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)

K, T, SITES = 5, 25, 4
NAMES = ("paper", "uniform", "ball_cover", "coreset")
PARAMS = {"uniform": {"budget": 120}, "coreset": {"budget": 120}}


def _cloud(seed, n=1200, d=4):
    """A normal cloud with 30 scattered outliers, on an integer grid."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.choice(n, 30, replace=False)
    x[ids] += rng.uniform(-25, 25, size=(30, d)).astype(np.float32)
    return np.round(x * 4)


def _gauss(grid=False):
    x, truth = gauss(n_centers=5, per_center=400, d=5, sigma=0.1, t=T,
                     seed=0)
    return (np.round(x * 8) if grid else x), truth


def _summary_fields(got, want):
    for name in ("indices", "weights", "sigma", "is_candidate", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert got.n_rounds == int(want.n_rounds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_summary_matches_reference(seed):
    x = _cloud(seed)
    key = jax.random.key(seed)
    want = jax_rand(jnp.asarray(x), key, budget=100)
    got = rand_summary(torch.as_tensor(x), JaxReplaySampler(key), budget=100)
    _summary_fields(got, want)
    assert np.unique(got.indices.numpy()).size == 100     # no repeats


@pytest.mark.parametrize("rounds", [1, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_parallel_matches_reference(seed, rounds):
    x = _cloud(seed + 10)
    key = jax.random.key(seed)
    want = jax_kpar(jnp.asarray(x), key, budget=100, rounds=rounds, sites=4)
    got = kmeans_parallel_summary(torch.as_tensor(x), JaxReplaySampler(key),
                                  budget=100, rounds=rounds, sites=4)
    _summary_fields(got.summary, want.summary)
    assert got.comm_records == float(want.comm_records)
    assert got.rounds == want.rounds == rounds
    # a repeated draw carries no mass: ties go to the smallest index
    ids, w = got.summary.indices.numpy(), got.summary.weights.numpy()
    first = np.unique(ids, return_index=True)[1]
    assert (np.delete(w, first) == 0).all() and w.sum() == x.shape[0]


@pytest.mark.parametrize("rounds,ell", [(1, 7), (3, 2), (5, 8)])
def test_comm_records_is_the_reference_formula(rounds, ell):
    x = jnp.zeros((rounds * ell, 2))
    for sites in (1, 4, 20):
        want = jax_kpar(x, jax.random.key(0), budget=rounds * ell,
                        rounds=rounds, sites=sites).comm_records
        assert comm_records(rounds, ell, sites) == float(want)
    # kdd's k-means|| row: 5 rounds of 8,747 over 20 sites, exact in f32
    assert comm_records(5, 8_747, 20) == 5 * 8_747 + 20 * 8_747 * 15


@pytest.mark.parametrize("name", NAMES)
def test_simulate_coordinator_summarizer_matches_reference(name):
    x, _ = _gauss(grid=name == "coreset")
    parts = np.array_split(x, SITES)
    key = jax.random.key(3)
    params = PARAMS.get(name, {})
    want = jax_simulate(parts, key, k=K, t=T,
                        summarizer=jsum.summarizer_policy(name, **params))
    got = simulate_coordinator(parts, JaxReplaySampler(key), k=K, t=T,
                               summarizer=summarizer_policy(name, **params),
                               device="cpu")
    for f in ("summary_ids", "outlier_ids", "summary_candidates"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if name == "coreset":
        np.testing.assert_allclose(got["summary_weights"],
                                   want["summary_weights"], rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got["summary_weights"],
                                      want["summary_weights"])
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-5,
                               atol=1e-5)
    assert got["comm_records"] == want["comm_records"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert got["site_records"] == [
        int(((got["summary_ids"] >= lo) & (got["summary_ids"] < hi)).sum())
        for lo, hi in zip(np.cumsum([0] + [len(p) for p in parts]),
                          np.cumsum([len(p) for p in parts]))]


@pytest.mark.parametrize("name", ["uniform", "ball_cover"])
def test_run_oneshot_summarizer_matches_reference(name):
    x, _ = _gauss()
    params = PARAMS.get(name, {})
    pipeline = pipeline_config(dim=5, k=K, t=T, sites=SITES, seed=2,
                               summarizer=jsum.summarizer_policy(name,
                                                                 **params))
    want = jax_run_oneshot(x, pipeline)
    got = _run_oneshot(
        x, torch_pipeline_config(dim=5, k=K, t=T, sites=SITES, seed=2,
                                 summarizer=summarizer_policy(name,
                                                              **params)),
        device="cpu", sampler=JaxReplaySampler(jax.random.key(2)))
    for f in ("summary_ids", "outlier_ids", "summary_weights"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-5,
                               atol=1e-5)
    assert got["comm_records"] == want["comm_records"]


@pytest.mark.parametrize("name", NAMES)
def test_coordinator_invariants_under_torch_sampler(name):
    x, truth = _gauss()
    parts = np.array_split(x, SITES)
    t_i = local_budget(T, SITES, "random")
    pol = summarizer_policy(name, **PARAMS.get(name, {}))
    res = simulate_coordinator(parts, TorchSampler(11), k=K, t=T,
                               summarizer=pol, device="cpu")
    offs = np.cumsum([0] + [p.shape[0] for p in parts])
    w, cand, gid = (res["summary_weights"], res["summary_candidates"],
                    res["summary_ids"])
    for i, part in enumerate(parts):
        site = (gid >= offs[i]) & (gid < offs[i + 1])
        np.testing.assert_allclose(w[site].sum(), part.shape[0],
                                   rtol=1e-4 if name == "coreset" else 0)
        assert np.unique(gid[site]).size == site.sum()      # no repeats
        assert cand[site].sum() <= 8 * t_i
        if name in ("paper", "ball_cover"):
            assert res["site_rounds"][i] <= max_rounds(part.shape[0], t_i,
                                                       0.45) + 4
    assert res["comm_records"] == len(gid) == sum(res["site_records"])
    assert res["centers"].shape == (K, 5) and np.isfinite(res["cost"])
    again = simulate_coordinator(parts, TorchSampler(11), k=K, t=T,
                                 summarizer=pol, device="cpu")
    for f in ("summary_ids", "outlier_ids", "centers"):
        np.testing.assert_array_equal(again[f], res[f])         # same seed


@pytest.mark.parametrize("baseline", ["rand", "k-means||"])
def test_baselines_under_torch_sampler(baseline):
    x = torch.as_tensor(_cloud(5))
    n = x.shape[0]

    def run(seed):
        if baseline == "rand":
            return rand_summary(x, TorchSampler(seed), budget=200)
        return kmeans_parallel_summary(x, TorchSampler(seed), budget=200,
                                       sites=4).summary

    a = run(4)
    assert float(a.weights.sum()) == n                       # mass conserved
    assert torch.equal(a.points, x[a.indices.long()])
    assert bool(torch.isin(a.sigma, a.indices).all())
    b = run(4)
    assert torch.equal(a.indices, b.indices) and torch.equal(a.weights,
                                                             b.weights)
    assert not torch.equal(a.indices, run(5).indices)


def test_reservoir_takes_equal_keys_in_row_order():
    # unit weights: the keys are log(u); rows 3, 5 and 9 tie at the
    # boundary of the 4 largest keys, so the smallest ids of them are taken
    u = torch.tensor([0.1, 0.9, 0.2, 0.5, 0.95, 0.5, 0.3, 0.05, 0.4, 0.5],
                     dtype=torch.float32)
    w = torch.ones(10)
    assert reservoir_ids(u, w, 4).tolist() == [1, 3, 4, 5]
    assert reservoir_ids(u, w, 3).tolist() == [1, 3, 4]
    # weights scale the keys: log(u) / w, the largest first
    w2 = torch.ones(10)
    w2[0] = 100.0
    assert 0 in reservoir_ids(u, w2, 3).tolist()


def test_run_oneshot_summarizer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = _gauss()
    with pytest.raises(RuntimeError, match="cuda"):
        _run_oneshot(x, torch_pipeline_config(
            dim=5, k=K, t=T, sites=SITES,
            summarizer=summarizer_policy("uniform", budget=50)))
