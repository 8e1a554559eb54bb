"""The port's Algorithm 1/2 summaries and second level against the
reference, on the CPU, under the replay sampler.

``JaxReplaySampler`` draws exactly what the reference draws from the same
key, so summary ids, sigma and weights must be equal, and the k-means--
centers equal to 1e-5 (f32 rounding of sums taken in another order) with
equal outlier masks.  Data: ``examples/oneshot.json``'s gauss 5x400, d=5,
k=5, t=25 over 4 sites, plus a t >> k case (gauss on an integer grid) where
Alg. 2 adds many centers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.augmented import (augmented_summary_compact as jax_aug_c,
                                  augmented_summary_outliers as jax_aug)
from repro.core.kmeans_mm import _kmeans_minus_minus_warm
from repro.core.kmeans_mm import kmeans_minus_minus as jax_kmm
from repro.core.kmeans_pp import kmeanspp_seed as jax_seed
from repro.core.kmeans_pp import kmeanspp_summary as jax_pp_summary
from repro.core.summary import summary_outliers as jax_so
from repro.core.summary import summary_outliers_compact as jax_so_c
from repro.data.synthetic import gauss as jax_gauss
from repro.kernels.dispatch import KernelPolicy as JaxPolicy
from repro_torch.core.augmented import (augmented_summary_compact,
                                        augmented_summary_outliers)
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.kmeans_pp import kmeanspp_seed, kmeanspp_summary
from repro_torch.core.summary import (information_loss, summary_outliers,
                                      summary_outliers_compact)
from repro_torch.data.synthetic import gauss
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)

# (gauss kwargs, k, t_i): oneshot.json's first site, and a t >> k site
CASES = {
    "oneshot_json": (dict(n_centers=5, per_center=400, d=5, sigma=0.1, t=25,
                          seed=0), 5, 13),
    "t_gg_k": (dict(n_centers=3, per_center=2000, d=4, sigma=0.1, t=150,
                    seed=1), 3, 150),
}
SUMMARIES = {
    "fixed": (summary_outliers, jax_so),
    "compact": (summary_outliers_compact, jax_so_c),
    "augmented": (augmented_summary_outliers, jax_aug),
    "augmented_compact": (augmented_summary_compact, jax_aug_c),
}


def _site(case):
    kw, k, t_i = CASES[case]
    x, _ = gauss(**kw)
    if case == "t_gg_k":
        # integer coordinates: every distance is an exact small integer in
        # f32, whatever order a matmul sums in, so Alg. 1's ball radius
        # cuts the same points on both sides (with float data one point in
        # ~1e4 sits within an ulp of rho and flips with the summation order
        # of XLA's vs torch's CPU dot; see the float case above)
        return np.round(x[: x.shape[0] // 2] * 8.0), k, t_i
    return x[:500], k, t_i


def test_synthetic_data_is_the_reference_copy():
    for kw, _, _ in CASES.values():
        (a, ia), (b, ib) = gauss(**kw), jax_gauss(**kw)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("alg", list(SUMMARIES))
def test_summary_matches_reference_under_replay(case, alg):
    x, k, t_i = _site(case)
    port, ref = SUMMARIES[alg]
    key = jax.random.key(7)
    want = ref(jnp.asarray(x), key, k=k, t=t_i)
    got = port(torch.as_tensor(x), JaxReplaySampler(key), k=k, t=t_i)
    for name in ("indices", "weights", "is_candidate", "valid", "sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert got.n_rounds == int(want.n_rounds)
    assert got.n_remaining == int(want.n_remaining)
    if alg.startswith("augmented") and case == "t_gg_k":
        # Alg. 2 really augmented: more centers than Alg. 1's rounds drew
        assert int((got.valid & ~got.is_candidate).sum()) > 100


def _records(case="oneshot_json"):
    """Summary records (points, integer weights) of one site."""
    x, k, t_i = _site(case)
    s = jax_aug(jnp.asarray(x), jax.random.key(1), k=k, t=t_i)
    valid = np.asarray(s.valid)
    return (np.asarray(s.points)[valid], np.asarray(s.weights)[valid], k,
            t_i)


def test_kmeanspp_seed_indices_equal():
    pts, w, k, _ = _records()
    key = jax.random.key(4)
    want, want_d = jax_seed(jnp.asarray(pts), jnp.asarray(w), key, budget=k)
    got, got_d = kmeanspp_seed(torch.as_tensor(pts), torch.as_tensor(w),
                               JaxReplaySampler(key), budget=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-6)


def test_kmeanspp_summary_matches_reference():
    x, _, _ = _site("oneshot_json")
    key = jax.random.key(9)
    want = jax_pp_summary(jnp.asarray(x), key, budget=12)
    got = kmeanspp_summary(torch.as_tensor(x), JaxReplaySampler(key),
                           budget=12)
    for name in ("indices", "weights", "sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("case", list(CASES))
def test_kmeans_minus_minus_warm_matches_reference(case):
    """The warm path is deterministic: no sampler involved."""
    pts, w, k, t_i = _records(case)
    valid = np.ones(len(pts), bool)
    c0 = pts[:: max(1, len(pts) // k)][:k]
    want = _kmeans_minus_minus_warm(
        jnp.asarray(pts), jnp.asarray(w), jnp.asarray(valid), jnp.asarray(c0),
        t=float(t_i), iters=25, metric="l2sq", policy=JaxPolicy())
    got = kmeans_minus_minus(torch.as_tensor(pts), torch.as_tensor(w),
                             torch.as_tensor(valid), None, k=k, t=float(t_i),
                             init_centers=torch.as_tensor(c0))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.outlier.numpy(),
                                  np.asarray(want.outlier))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)


def test_kmeans_minus_minus_cold_matches_reference_under_replay():
    pts, w, k, t_i = _records()
    valid = np.ones(len(pts), bool)
    key = jax.random.key(5)
    want = jax_kmm(jnp.asarray(pts), jnp.asarray(w), jnp.asarray(valid), key,
                   k=k, t=float(t_i))
    got = kmeans_minus_minus(torch.as_tensor(pts), torch.as_tensor(w),
                             torch.as_tensor(valid), JaxReplaySampler(key),
                             k=k, t=float(t_i))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.outlier.numpy(),
                                  np.asarray(want.outlier))


def test_information_loss_matches_reference():
    from repro.core.summary import information_loss as jax_loss
    x, k, t_i = _site("oneshot_json")
    s = jax_so_c(x, jax.random.key(2), k=k, t=t_i)
    for metric in ("l2sq", "l2", "l1"):
        want = jax_loss(jnp.asarray(x), s.sigma, metric)
        got = information_loss(torch.as_tensor(x),
                               torch.as_tensor(np.array(s.sigma)), metric)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
