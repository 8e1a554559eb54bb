"""The port's one-shot Algorithm 3 and its serving model, end to end on the
CPU, against the reference.

Under the replay sampler ``simulate_coordinator`` must give the reference's
outlier and summary ids and its centers to 1e-5; the serving model built
from a result must match the reference's ``_model_from_result``; a model
carried across from the reference must score like its ``_score_batch``.
Under ``TorchSampler`` (no JAX draws) the paper's invariants hold: mass is
conserved per site, |X_r| <= 8 t_i, rounds stay within ``_plan``, and a
fixed seed reproduces the run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import pipeline_config as jax_pipeline_config
from repro.api.session import _model_from_result as jax_model_from_result
from repro.api.session import _run_oneshot as jax_run_oneshot
from repro.core.distributed import simulate_coordinator as jax_simulate
from repro.kernels.dispatch import KernelPolicy as JaxPolicy
from repro.stream.service import _score_batch as jax_score_batch
from repro_torch.api.config import pipeline_config
from repro_torch.api.session import _model_from_result, _run_oneshot
from repro_torch.core.distributed import local_budget, simulate_coordinator
from repro_torch.core.metrics import clustering_losses, outlier_scores
from repro_torch.core.sampler import TorchSampler
from repro_torch.core.summary import _plan
from repro_torch.data.synthetic import gauss
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.stream.service import (_score_batch, fit_model,
                                        model_from_arrays)
from repro_torch.summarize import SummarizerPolicy
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)

# examples/oneshot.json: gauss 5x400, d=5, t=25; k=5 over 4 sites
K, T, SITES = 5, 25, 4


def _data():
    return gauss(n_centers=5, per_center=400, d=5, sigma=0.1, t=T, seed=0)


@pytest.fixture(scope="module")
def replayed():
    x, truth = _data()
    key = jax.random.key(0)
    want = jax_run_oneshot(x, jax_pipeline_config(dim=5, k=K, t=T,
                                                  sites=SITES))
    got = _run_oneshot(x, pipeline_config(dim=5, k=K, t=T, sites=SITES),
                       device="cpu", sampler=JaxReplaySampler(key))
    return x, truth, want, got


@pytest.mark.parametrize("summary_alg", ["augmented", "plain"])
def test_simulate_coordinator_matches_reference(summary_alg):
    x, _ = _data()
    key = jax.random.key(3)
    parts = np.array_split(x, SITES)
    want = jax_simulate(parts, key, k=K, t=T, summary_alg=summary_alg)
    got = simulate_coordinator(parts, JaxReplaySampler(key), k=K, t=T,
                               summary_alg=summary_alg, device="cpu")
    for name in ("summary_ids", "outlier_ids", "summary_weights",
                 "summary_candidates"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-5,
                               atol=1e-5)
    assert got["comm_records"] == want["comm_records"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)


def test_run_oneshot_matches_reference_host_sim(replayed):
    _, _, want, got = replayed
    np.testing.assert_array_equal(got["outlier_ids"], want["outlier_ids"])
    np.testing.assert_array_equal(got["summary_ids"], want["summary_ids"])
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-5,
                               atol=1e-5)


def test_model_from_result_matches_reference(replayed):
    x, _, want_res, got_res = replayed
    pipeline = jax_pipeline_config(dim=5, k=K, t=T, sites=SITES)
    want = jax_model_from_result(x, want_res, pipeline, 3)
    got = _model_from_result(x, got_res,
                             pipeline_config(dim=5, k=K, t=T, sites=SITES),
                             3, device="cpu")
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    for name in ("threshold", "cost", "trained_weight"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    assert int(got.version) == int(want.version) == 3


def test_model_from_arrays_scores_like_reference(replayed):
    x, truth, want_res, _ = replayed
    pipeline = jax_pipeline_config(dim=5, k=K, t=T, sites=SITES)
    jm = jax_model_from_result(x, want_res, pipeline, 1)
    # the dict ServingFrontEnd._model_arrays produces, as numpy leaves
    md = {name: np.asarray(getattr(jm, name)) for name in
          ("centers", "threshold", "cost", "version", "trained_weight")}
    model = model_from_arrays(md, device="cpu")
    xb = np.zeros((256, 5), np.float32)
    xb[:200] = x[np.r_[truth[:20], np.arange(180)]]   # planted + clean rows
    want = jax_score_batch(jnp.asarray(xb), jm.centers, jm.threshold,
                           metric="l2sq", policy=JaxPolicy())
    got = _score_batch(torch.as_tensor(xb), model.centers, model.threshold,
                       metric="l2sq", policy=KernelPolicy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)
    assert (got[2][:20] > 1).float().mean() > 0.5     # planted rows flagged


def test_fit_model_threshold_rule():
    x, _ = _data()
    pts = torch.as_tensor(x[:400])
    valid = torch.ones((400,), dtype=torch.bool)
    model = fit_model(pts, torch.ones((400,)), valid, TorchSampler(1), 2,
                      k=K, t=10, iters=10, metric="l2sq", policy=None)
    d, _, s = _score_batch(pts, model.centers, model.threshold,
                           metric="l2sq", policy=None)
    # the threshold is the largest inlier distance: exactly t records exceed it
    assert int((s > 1).sum()) == 10
    assert float(model.trained_weight) == 400.0 and int(model.version) == 2


@pytest.mark.parametrize("summary_alg", ["augmented", "plain"])
def test_invariants_under_torch_sampler(summary_alg):
    x, truth = _data()
    parts = np.array_split(x, SITES)
    t_i = local_budget(T, SITES, "random")
    res = simulate_coordinator(parts, TorchSampler(11), k=K, t=T,
                               summary_alg=summary_alg, device="cpu")
    offs = np.cumsum([0] + [p.shape[0] for p in parts])
    w, cand, gid = (res["summary_weights"], res["summary_candidates"],
                    res["summary_ids"])
    for i, part in enumerate(parts):
        site = (gid >= offs[i]) & (gid < offs[i + 1])
        assert w[site].sum() == part.shape[0]            # mass conserved
        assert cand[site].sum() <= 8 * t_i               # |X_r| <= 8 t_i
        assert res["site_rounds"][i] <= _plan(part.shape[0], K, t_i, 2.0,
                                              0.45)[2]
    assert len(res["outlier_ids"]) <= T
    sc = outlier_scores(truth, gid, res["outlier_ids"])
    assert sc.pre_recall > 0.9 and sc.recall > 0.8
    again = simulate_coordinator(parts, TorchSampler(11), k=K, t=T,
                                 summary_alg=summary_alg, device="cpu")
    for name in ("summary_ids", "outlier_ids", "centers"):
        np.testing.assert_array_equal(again[name], res[name])   # same seed
    mask = torch.zeros((x.shape[0],), dtype=torch.bool)
    mask[torch.as_tensor(res["outlier_ids"])] = True
    l1, l2 = clustering_losses(torch.as_tensor(x),
                               torch.as_tensor(res["centers"]), mask)
    assert 0 < float(l1) and float(l1) ** 2 <= float(l2) * x.shape[0]


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = _data()
    with pytest.raises(RuntimeError, match="cuda"):
        _run_oneshot(x, pipeline_config(dim=5, k=K, t=T, sites=SITES))
    with pytest.raises(RuntimeError, match="cuda"):
        model_from_arrays({"centers": np.zeros((K, 5))})
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_coordinator([x], TorchSampler(0), k=K, t=T,
                             summarizer=SummarizerPolicy("paper"))
