"""`rand` baseline summary: uniform sample + nearest-neighbour weights.

Port of ``repro.core.rand_summary``.  Each site samples `budget` points
uniformly without replacement, assigns every local point to its nearest
sample (one ``min_argmin``), and weights samples by assignment counts.  One
round of communication, same record format as the paper's summary — but no
outlier candidates, which is why it fails at outlier detection (paper
Tables 2-4).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import Summary
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin


def rand_summary(
    x: torch.Tensor,
    sampler: Sampler,
    *,
    budget: int,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
) -> Summary:
    """The `rand` summary of ``x``, on ``x``'s device."""
    policy = resolve_policy(policy)
    n = x.shape[0]
    dev = x.device
    idx = sampler.choice(n, (budget,), replace=False, device=dev)
    centers = x[idx]
    _, amin = min_argmin(x, centers, metric=metric, policy=policy)
    amin = amin.long()
    counts = torch.zeros((budget,), dtype=torch.float32, device=dev)
    counts.index_add_(0, amin, torch.ones((n,), device=dev))
    return Summary(
        indices=idx.to(torch.int32),
        points=centers,
        weights=counts,
        is_candidate=torch.zeros((budget,), dtype=torch.bool, device=dev),
        valid=torch.ones((budget,), dtype=torch.bool, device=dev),
        sigma=idx[amin].to(torch.int32),
        n_rounds=1,
        n_remaining=0,
    )
