"""k-means-- (Chawla & Gionis 2013), weighted, as the second-level clusterer.

Port of ``repro.core.kmeans_mm``.  Lloyd-style alternation that jointly
optimizes k centers and t outliers: each iteration assigns points to
nearest centers (one fused ``lloyd_step``), marks the farthest mass (total
weight <= t) as outliers, and recomputes centers from the inliers.  A
summary record (q, w_q) acts as w_q coincident points.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.kmeans_pp import kmeanspp_seed
from repro_torch.core.sampler import Sampler
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.lloyd.ops import accumulate_by_assignment, lloyd_step
from repro_torch.kernels.pdist.ops import min_argmin


class OutlierClustering(NamedTuple):
    centers: torch.Tensor       # (k, d)
    assignment: torch.Tensor    # (n,) int32 — nearest-center index
    outlier: torch.Tensor       # (n,) bool
    cost: torch.Tensor          # () weighted objective over inliers
    distances: torch.Tensor     # (n,) distance to assigned center


def _mark_outliers(dist, w_eff, t):
    """Greedy farthest-first: True for records whose cumulative weight
    (in decreasing-distance order) stays within the budget t.  The sort is
    stable, as ``jnp.argsort`` is: equal distances keep index order."""
    order = torch.argsort(-dist, stable=True)
    w_sorted = w_eff[order]
    out_sorted = (torch.cumsum(w_sorted, dim=0) <= t) & (w_sorted > 0)
    out = torch.zeros_like(out_sorted)
    out[order] = out_sorted
    return out


def kmeans_minus_minus(
    points: torch.Tensor,
    weights: torch.Tensor,
    valid: torch.Tensor,
    sampler: Optional[Sampler],
    *,
    k: int,
    t: float,
    iters: int = 25,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> OutlierClustering:
    """``init_centers`` (k, d): warm-start the Lloyd loop from these
    centers instead of k-means++ seeding (``sampler`` is then unused)."""
    policy = resolve_policy(policy)
    w = weights.float() * valid
    if init_centers is None:
        seed_idx, _ = kmeanspp_seed(points, w, sampler, budget=k,
                                    metric=metric)
        centers0 = points[seed_idx.long()].float()
    else:
        centers0 = torch.as_tensor(init_centers, dtype=torch.float32,
                                   device=points.device)
        if tuple(centers0.shape) != (k, points.shape[1]):
            raise ValueError(
                f"init_centers must have shape ({k}, {points.shape[1]}), "
                f"got {tuple(centers0.shape)}")
    return _lloyd_outlier_loop(points, w, valid, centers0, k=k, t=t,
                               iters=iters, metric=metric, policy=policy)


def _lloyd_outlier_loop(points, w, valid, centers0, *, k, t, iters, metric,
                        policy) -> OutlierClustering:
    """The alternation after seeding, shared by the cold and warm paths."""
    with obs.span("kmeans_mm.lloyd", iters=iters):
        centers = centers0
        for _ in range(iters):
            # One registry-dispatched fused Lloyd step (assign + accumulate);
            # the outlier mask then corrects the accumulators with a one-hot
            # matmul over the inlier weights — no second distance pass.
            _, _, amin, dist = lloyd_step(points, w, centers, metric=metric,
                                          policy=policy)
            # padding: never out
            dist = torch.where(valid, dist, float("-inf"))
            out = _mark_outliers(dist, w, t)
            sums, cnts = accumulate_by_assignment(points, w * ~out, amin, k)
            centers = torch.where(cnts[:, None] > 0,
                                  sums / torch.clamp(cnts, min=1e-9)[:, None],
                                  centers)
        dist, amin = min_argmin(points, centers, metric=metric, policy=policy)
        dist = torch.where(valid, dist, float("-inf"))
        out = _mark_outliers(dist, w, t)
        cost = torch.sum(torch.where(valid & ~out, dist, 0.0) * w)
        return OutlierClustering(
            centers=centers,
            assignment=amin.to(torch.int32),
            outlier=out & valid,
            cost=cost,
            distances=torch.where(valid, dist, float("inf")),
        )
