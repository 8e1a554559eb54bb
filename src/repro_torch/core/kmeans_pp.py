"""Weighted k-means++ (Arthur & Vassilvitskii 2007) D^p seeding.

Port of ``repro.core.kmeans_pp``: seeding for the second-level k-means--
at the coordinator, and the paper's `k-means++` baseline summary.
p = 2 for (k,t)-means, p = 1 for (k,t)-median.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import Summary
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin


def _dist_to(x, c, metric):
    if metric == "l1":
        return (x - c[None, :]).abs().sum(-1)
    if metric == "cosine":
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                             min=1e-30)
        cn = c / torch.clamp(torch.linalg.vector_norm(c), min=1e-30)
        return torch.clamp(1.0 - xn @ cn, 0.0, 2.0)
    sq = ((x - c[None, :]) ** 2).sum(-1)
    return sq if metric == "l2sq" else torch.sqrt(sq)


def kmeanspp_seed(x: torch.Tensor, w: torch.Tensor, sampler: Sampler, *,
                  budget: int, metric: str = "l2sq"):
    """Pick ``budget`` rows of ``x`` by weighted D^p sampling.

    Returns (center indices (budget,) int32, min-dist of every point to the
    chosen set).  Zero-weight rows are never chosen.  One ``split`` and one
    scalar categorical draw per pick, as the reference's scan.
    """
    n = x.shape[0]
    x = x.float()
    w = w.float()
    mind = torch.full((n,), float("inf"), dtype=torch.float32, device=x.device)
    key = sampler
    picks = []
    with obs.span("kmeans_pp.seed", picks=budget):
        for _ in range(budget):
            key, sk = key.split(2)
            score = w * mind
            # first pick: plain weighted sampling (mind starts at +inf -> w)
            score = torch.where(torch.isinf(mind), w, score)
            score = torch.where(score.sum() > 0, score, w)
            logits = torch.log(torch.clamp(score, min=1e-30))
            logits = torch.where(w > 0, logits, float("-inf"))
            idx = sk.categorical(logits, caller="kmeans_pp.pick")
            mind = torch.minimum(mind, _dist_to(x, x[idx], metric))
            picks.append(idx)
    ids = (torch.stack(picks) if picks
           else torch.empty((0,), dtype=torch.int64, device=x.device))
    return ids.to(torch.int32), mind


def pp_budget(n: int, k: int, t: int) -> int:
    """The paper's baseline budget O(k log n + t)."""
    return int(k * max(1, math.ceil(math.log(max(n, 2)))) + t)


def kmeanspp_summary(x: torch.Tensor, sampler: Sampler, *, budget: int,
                     metric: str = "l2sq",
                     policy: Optional[KernelPolicy] = None) -> Summary:
    """The `k-means++` baseline summary: budgeted seeding + nearest counts."""
    policy = resolve_policy(policy)
    n, d = x.shape
    dev = x.device
    idx, _ = kmeanspp_seed(x, torch.ones((n,), device=dev), sampler,
                           budget=budget, metric=metric)
    centers = x[idx.long()]
    _, amin = min_argmin(x, centers, metric=metric, policy=policy)
    counts = torch.zeros((budget,), dtype=torch.float32, device=dev)
    counts.index_add_(0, amin.long(), torch.ones((n,), device=dev))
    return Summary(
        indices=idx,
        points=centers,
        weights=counts,
        is_candidate=torch.zeros((budget,), dtype=torch.bool, device=dev),
        valid=torch.ones((budget,), dtype=torch.bool, device=dev),
        sigma=idx[amin.long()],
        n_rounds=budget,
        n_remaining=0,
    )
