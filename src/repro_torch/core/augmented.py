"""Algorithm 2 (Augmented-Summary-Outliers).

Port of ``repro.core.augmented``.  When t >> k the plain summary is
outlier-heavy: |X_r| ~ 8t candidates but only O(k log n) centers.  The
augmentation samples |X_r| - |S| extra centers S' from X \\ (X_r u S) and
reassigns every non-candidate point to its nearest center in S u S' — one
fused min-dist + argmin pass over (n x |S u S'|), the largest distance call
of the main path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import (Summary, _plan, nonzero_fixed,
                                      summary_outliers,
                                      summary_outliers_compact)
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin

_FAR = 1e30  # sentinel coordinate for invalid center slots


def _mask_of(ids: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool with True at ``ids[keep]`` (the reference's
    ``zeros(n).at[where(keep, ids, n)].set(True, mode="drop")``)."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=ids.device)
    out[torch.where(keep, ids.long(), n)] = True
    return out[:n]


def _ones(n: int, dev) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=dev)


def augmented_summary_compact(
    x: torch.Tensor,
    sampler: Sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
) -> Summary:
    """Algorithm 2 with the paper's O(t*n) cost: compact Algorithm 1, then
    one fused min-dist+argmin pass for the reassignment."""
    policy = resolve_policy(policy)
    n, d = x.shape
    dev = x.device
    key, k1, k2 = sampler.fold_in(17).split(3)
    base = summary_outliers_compact(x, k1, k=k, t=t, alpha=alpha, beta=beta,
                                    metric=metric, policy=policy)
    sel = base.indices.long()
    cand_ids = sel[base.is_candidate]
    center_ids = sel[~base.is_candidate]
    extra = max(int(cand_ids.numel()) - int(center_ids.numel()), 0)
    if extra:
        with obs.span("alg2.extra"):
            free = torch.ones((n,), dtype=torch.bool, device=dev)
            free[sel] = False
            eligible = torch.nonzero(free).flatten()       # sorted setdiff
            if eligible.numel() == 0:
                eligible = torch.arange(n, device=dev)
            pick = k2.randint(eligible.numel(), (extra,), device=dev,
                              caller="alg2.extra")
            center_ids = torch.cat([center_ids, eligible[pick]])
    # Line 3: reassign everything outside X_r to nearest center in S u S'
    with obs.span("alg2.reassign"):
        _, amin = min_argmin(x, x[center_ids], metric=metric, policy=policy)
        pi = center_ids[amin.long()]
        pi[cand_ids] = cand_ids
        w = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
            0, pi, _ones(n, dev))
    uc = torch.unique(center_ids)
    all_ids = torch.cat([uc, cand_ids])
    is_cand = torch.cat([torch.zeros((uc.numel(),), dtype=torch.bool,
                                     device=dev),
                         torch.ones((cand_ids.numel(),), dtype=torch.bool,
                                    device=dev)])
    return Summary(
        indices=all_ids.to(torch.int32),
        points=x[all_ids],
        weights=w[all_ids],
        is_candidate=is_cand,
        valid=torch.ones((all_ids.numel(),), dtype=torch.bool, device=dev),
        sigma=pi.to(torch.int32),
        n_rounds=base.n_rounds,
        n_remaining=base.n_remaining,
    )


def augmented_summary_outliers(
    x: torch.Tensor,
    sampler: Sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
) -> Summary:
    """Fixed-shape Algorithm 2 on ``x``'s device."""
    policy = resolve_policy(policy)
    if metric == "cosine":
        # invalid center slots sit at a far-away coordinate; under a
        # direction-only metric that is an ordinary direction
        raise ValueError(
            "augmented_summary_outliers does not support metric='cosine'; "
            "use summary_outliers")
    n, d = x.shape
    dev = x.device
    key, k1, k2 = sampler.split(3)
    base = summary_outliers(x, k1, k=k, t=t, alpha=alpha, beta=beta,
                            metric=metric, policy=policy)
    _, m, rounds, _ = _plan(n, k, t, alpha, beta)

    # Existing center / candidate masks over X (from the base summary).
    cand_mask = _mask_of(base.indices, base.valid & base.is_candidate, n)
    center_mask = _mask_of(base.indices, base.valid & ~base.is_candidate, n)
    n_cand = int((base.valid & base.is_candidate).sum())
    n_centers = int((base.valid & ~base.is_candidate).sum())

    # Line 2: sample |X_r| - |S| extra centers from X \ (X_r u S).
    extra_cap = 8 * t + 1  # |X_r| <= 8t, so never need more than this
    with obs.span("alg2.extra"):
        eligible = ~(cand_mask | center_mask)
        if bool(eligible.any()):
            logits = torch.where(eligible, 0.0, float("-inf"))
        else:   # nothing eligible: sample anywhere
            logits = torch.zeros((n,), dtype=torch.float32, device=dev)
        extra_idx = k2.categorical(logits, (extra_cap,), caller="alg2.extra")
        extra_valid = (torch.arange(extra_cap, device=dev)
                       < max(n_cand - n_centers, 0))
        all_center_mask = center_mask | _mask_of(extra_idx, extra_valid, n)

    with obs.span("alg2.reassign"):
        center_cap = rounds * m + extra_cap
        c_idx = nonzero_fixed(all_center_mask, center_cap, n)
        xp = torch.cat([x, torch.full((1, d), _FAR, dtype=x.dtype,
                                      device=dev)])
        c_pts = xp[c_idx]  # invalid slots sit at _FAR -> never nearest

        # Line 3: reassign every x in X \ X_r to its nearest center in S u S'.
        _, amin = min_argmin(x, c_pts, metric=metric, policy=policy)
        pi = torch.where(cand_mask, torch.arange(n, device=dev),
                         c_idx[amin.long()])

        # Line 4: weights under the new mapping.
        w = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
            0, pi, _ones(n, dev))

    cap = center_cap + 8 * t + 1
    idx_q = nonzero_fixed(all_center_mask | cand_mask, cap, n)
    xz = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=dev)])
    wp = torch.cat([w, torch.zeros((1,), dtype=torch.float32, device=dev)])
    candp = torch.cat([cand_mask,
                       torch.zeros((1,), dtype=torch.bool, device=dev)])
    return Summary(
        indices=idx_q.to(torch.int32),
        points=xz[idx_q],
        weights=wp[idx_q],
        is_candidate=candp[idx_q],
        valid=idx_q < n,
        sigma=pi.to(torch.int32),
        n_rounds=base.n_rounds,
        n_remaining=base.n_remaining,
    )
