"""The generators' torch copies against the numpy generators they copy:
the same shapes, planted counts and moments; the same rows from the same
seed, other rows from another."""
import numpy as np
import pytest
import torch

from bench.harness.data import make_data
from bench.harness.spec import load_named
from repro_torch.data import synthetic

kdd_like = load_named("datasets", "kdd_like").make
susy_like = load_named("datasets", "susy_like").make


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("n", [20_000, 4_898_431 // 64])
def test_kdd_like_counts_and_moments_match_numpy(n):
    x, truth = kdd_like(n, 34, _gen(3), "cpu", t_frac=0.0093)
    xn, out_np = synthetic.kdd_like(n=n, d=34, seed=3)
    assert x.shape == xn.shape and x.dtype == torch.float32
    assert int(truth.sum()) == out_np.size
    assert np.allclose(x.mean(0).numpy(), 0.0, atol=1e-4)
    assert np.allclose(x.std(0, unbiased=False).numpy(), 1.0, atol=1e-4)


def test_kdd_like_full_size_plants_the_configs_t():
    n = 4_898_431
    fracs = np.full(20, 0.0093 / 20)
    assert int((np.maximum((fracs * n).astype(int), 1)).sum()) == 45_540
    assert int((np.maximum((fracs * (n - 3)).astype(int), 1)).sum()) == 45_540


def test_susy_like_plants_t_far_rows():
    x, truth = susy_like(50_000, 18, _gen(4), "cpu", t=500, delta=5.0)
    xn, out_np = synthetic.susy_like(n=50_000, t=500, delta=5.0, seed=4)
    assert x.shape == xn.shape and int(truth.sum()) == out_np.size == 500
    far = x[truth].norm(dim=1).mean() / x[~truth].norm(dim=1).mean()
    far_np = (np.linalg.norm(xn[out_np], axis=1).mean()
              / np.linalg.norm(np.delete(xn, out_np, 0), axis=1).mean())
    assert abs(float(far) - far_np) < 0.15 * far_np


@pytest.mark.parametrize("workload", ["kddfull", "susy-d5"])
def test_same_seed_same_rows(workload):
    from bench.harness.spec import ROOT, load_json
    cfg = load_json(ROOT / "bench" / "configs" / f"{workload}.json")
    cfg = dict(cfg, n=5_000)
    if cfg["dataset"] == "susy_like":
        cfg["dataset_args"] = {"t": 50, "delta": 5.0}
    seed = 2**31 + 12345          # past 32 signed bits, as a run's may be
    a, ta = make_data(cfg, seed, "cpu")
    b, tb = make_data(cfg, seed, "cpu")
    c, _ = make_data(cfg, seed + 1, "cpu")
    assert torch.equal(a, b) and torch.equal(ta, tb)
    assert not torch.equal(a, c)
