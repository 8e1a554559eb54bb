"""k-means|| (Bahmani et al. 2012) baseline, budget-extended for outliers.

Port of ``repro.core.kmeans_parallel``.  The paper compares against
k-means|| with the center budget raised from k to O(k log n + t).  Each of
R rounds draws ``ell = budget // R`` candidates with probability
proportional to the current D^p cost (one ``min_argmin`` per round
refreshes it); a final ``min_argmin`` assigns every point to its nearest
candidate.  In the coordinator model every round gathers the new
candidates from all sites and broadcasts the union back, so its
communication grows with both R and s (paper Fig 1a):

    comm_records = sum over rounds [ gathered candidates  +  s * |union| ]
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import Summary
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin


class KmeansParallelResult(NamedTuple):
    summary: Summary
    comm_records: float   # coordinator-model communication, in records
    rounds: int


def comm_records(rounds: int, ell: int, sites: int) -> float:
    """Round i gathers ell candidates and broadcasts the running union
    (i+1)*ell to each of the ``sites`` sites; in float32, as the reference
    computes it."""
    per_round = np.arange(1, rounds + 1) * ell
    return float(np.float32(rounds * ell)
                 + np.float32(sites) * np.float32(per_round.sum()))


def kmeans_parallel_summary(
    x: torch.Tensor,
    sampler: Sampler,
    *,
    budget: int,
    rounds: int = 5,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
    sites: int = 1,
) -> KmeansParallelResult:
    """The k-means|| summary of ``x``, on ``x``'s device.  Draws repeat
    (with replacement); a repeated candidate's count is 0, since ties go to
    the smallest index."""
    policy = resolve_policy(policy)
    n = x.shape[0]
    dev = x.device
    ell = max(1, budget // rounds)
    mind = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    key = sampler
    picks = []
    for _ in range(rounds):
        key, sk = key.split(2)
        score = torch.where(torch.isinf(mind), 1.0, mind)
        score = torch.where(score.sum() > 0, score, torch.ones_like(score))
        logits = torch.log(torch.clamp(score, min=1e-30))
        idx = sk.categorical(logits, (ell,))
        dists, _ = min_argmin(x, x[idx], metric=metric, policy=policy)
        mind = torch.minimum(mind, dists)
        picks.append(idx)
    idx = torch.cat(picks)                      # (rounds * ell,)
    centers = x[idx]
    _, amin = min_argmin(x, centers, metric=metric, policy=policy)
    amin = amin.long()
    counts = torch.zeros((idx.numel(),), dtype=torch.float32, device=dev)
    counts.index_add_(0, amin, torch.ones((n,), device=dev))
    summary = Summary(
        indices=idx.to(torch.int32),
        points=centers,
        weights=counts,
        is_candidate=torch.zeros((idx.numel(),), dtype=torch.bool,
                                 device=dev),
        valid=torch.ones((idx.numel(),), dtype=torch.bool, device=dev),
        sigma=idx[amin].to(torch.int32),
        n_rounds=rounds,
        n_remaining=0,
    )
    return KmeansParallelResult(summary=summary,
                                comm_records=comm_records(rounds, ell, sites),
                                rounds=rounds)
