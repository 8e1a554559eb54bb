"""Synthetic dataset generators matching the paper's Section 5.1.1.

* ``gauss(sigma)``  — exactly the paper's generator: ``n_centers`` centers
  uniform in [0,1]^d, ``per_center`` Gaussian points each, then ``t`` points
  re-sampled and shifted by U[-2,2]^d to become ground-truth outliers.
* ``kdd_like``      — statistically matched stand-in for kddFull/kddSp
  (offline container: the original is not redistributable here): d=34
  z-normalized features, 3 dominant clusters holding 98.3% of the mass with
  per-class scale spread, remaining mass in 20 small clusters treated as
  ground-truth outliers.
* ``susy_like``     — d=18 z-normalized 2-component mixture (signal/bkg) with
  ``t`` points shifted by U[-delta, delta]^d (the paper's susy-Delta).

All generators return (X float32 (n,d), outlier_ids int64) and take ``n`` so
paper-scale runs are a flag away on real hardware.
"""
from __future__ import annotations

import numpy as np


def gauss(
    n_centers: int = 100,
    per_center: int = 10_000,
    d: int = 5,
    sigma: float = 0.1,
    t: int = 5_000,
    seed: int = 0,
):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(n_centers, d))
    x = np.repeat(centers, per_center, axis=0) + rng.normal(
        0.0, sigma, size=(n_centers * per_center, d))
    n = x.shape[0]
    out_ids = rng.choice(n, size=t, replace=False)
    x[out_ids] += rng.uniform(-2.0, 2.0, size=(t, d))
    return x.astype(np.float32), np.sort(out_ids)


def drifting_gauss(
    n_phases: int = 3,
    n_centers: int = 8,
    per_center: int = 2_000,
    d: int = 5,
    sigma: float = 0.05,
    drift: float = 4.0,
    seed: int = 0,
):
    """Concept-shifting stream for sliding-window evaluation.

    Phase p draws ``n_centers * per_center`` points from fresh uniform
    centers inside the shifted box ``[p * drift, p * drift + 1]^d`` (rows
    shuffled within a phase, phases concatenated in stream order), so each
    phase occupies a disjoint region: a model fit on a window covering only
    the newest phase should sit in the newest box, while a full-stream model
    must split its k centers across all phases.

    Returns (X float32 (n_phases * n_centers * per_center, d) in stream
    order, phase_ids int64 (n,), centers float32 (n_phases, n_centers, d)).
    """
    rng = np.random.default_rng(seed)
    xs, phases, centers = [], [], []
    for p in range(n_phases):
        c = rng.uniform(0.0, 1.0, size=(n_centers, d)) + p * drift
        x = np.repeat(c, per_center, axis=0) + rng.normal(
            0.0, sigma, size=(n_centers * per_center, d))
        rng.shuffle(x, axis=0)
        xs.append(x)
        phases.append(np.full(x.shape[0], p))
        centers.append(c)
    return (np.concatenate(xs).astype(np.float32), np.concatenate(phases),
            np.stack(centers).astype(np.float32))


def kdd_like(n: int = 500_000, d: int = 34, t_frac: float = 0.0093, seed: int = 0):
    rng = np.random.default_rng(seed)
    big_frac = np.array([0.196, 0.216, 0.568])          # normal/neptune/smurf
    big_frac = big_frac / big_frac.sum() * (1.0 - t_frac)
    small_k = 20
    small_frac = np.full(small_k, t_frac / small_k)
    fracs = np.concatenate([big_frac, small_frac])
    ks = len(fracs)
    centers = rng.normal(0.0, 2.0, size=(ks, d))
    scales = rng.uniform(0.2, 1.0, size=(ks, 1))
    counts = np.maximum((fracs * n).astype(int), 1)
    counts[0] += n - counts.sum()
    xs, labels = [], []
    for i, c in enumerate(counts):
        xs.append(centers[i] + rng.normal(0.0, 1.0, size=(c, d)) * scales[i])
        labels.append(np.full(c, i))
    x = np.concatenate(xs).astype(np.float32)
    labels = np.concatenate(labels)
    perm = rng.permutation(x.shape[0])
    x, labels = x[perm], labels[perm]
    x = (x - x.mean(0)) / (x.std(0) + 1e-9)             # paper z-normalizes
    out_ids = np.nonzero(labels >= 3)[0]                # small clusters = outliers
    return x, np.sort(out_ids)


def susy_like(n: int = 500_000, d: int = 18, t: int = 5_000,
              delta: float = 5.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, 2, size=n)
    mu = np.stack([rng.normal(0, 1, d), rng.normal(0, 1, d)])
    x = mu[comp] + rng.normal(0.0, 1.0, size=(n, d))
    x = (x - x.mean(0)) / (x.std(0) + 1e-9)
    out_ids = rng.choice(n, size=t, replace=False)
    x[out_ids] += rng.uniform(-delta, delta, size=(t, d))
    return x.astype(np.float32), np.sort(out_ids)


def partition(x: np.ndarray, s: int, mode: str = "random", seed: int = 0,
              outlier_ids: np.ndarray | None = None):
    """Split rows of x into s site-parts.

    random      — the dispatcher model (paper's experiments).
    adversarial — all outliers (plus fill) land on site 0.
    Returns (parts, global_ids per part).
    """
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if mode == "random":
        perm = rng.permutation(n)
    elif mode == "adversarial":
        if outlier_ids is None:
            raise ValueError("adversarial partition needs outlier_ids")
        rest = np.setdiff1d(np.arange(n), outlier_ids)
        perm = np.concatenate([outlier_ids, rng.permutation(rest)])
    else:
        raise ValueError(mode)
    # equal-size parts (truncate the remainder, keeps shapes uniform)
    per = n // s
    parts, gids = [], []
    for i in range(s):
        ids = perm[i * per:(i + 1) * per]
        parts.append(x[ids])
        gids.append(ids)
    return parts, gids
