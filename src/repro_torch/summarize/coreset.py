"""The ``coreset`` summarizer: k-means||-seeded sensitivity sampling.

Port of ``repro.summarize.coreset``, in the spirit of Dandolo et al.
(arXiv:2202.08173): a coreset for k-means/median with outliers built from
any distance oracle, including ``cosine``.

Construction over weighted records (x_i, w_i):

1. **Seed** with a weighted k-means|| pass: ``seed_rounds`` rounds each
   drawing ``ceil(seed_budget / seed_rounds)`` records with probability
   ∝ w * D(x, S)^p, D refreshed once per round.
2. **Sensitivity** of record i with nearest seed j(i) and seed-cluster
   mass M_j:  s_i = w_i d_i / Σ w d  +  w_i / (|S| M_{j(i)}).
3. **Sample** ``budget`` records with replacement ∝ s_i, weight each
   unique pick c_i w_i / (budget p_i), then rescale so the output mass
   equals the input mass exactly.

The sensitivities are summed in float64 as in the reference, but in
torch's order rather than numpy's pairwise one, so ``probs`` can differ in
the last float64 bits; the draw is made from their float32 rounding, and
the weights carry the difference (relative ~1e-15 before the float32
cast).

No outlier candidates: sensitivity sampling keeps far records with high
probability but does not certify them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.summarize.base import (clean_weighted_input, empty_summary,
                                        register_summarizer)

_EPS = 1e-30


def _summarize(points, weights, sampler, *, k, t, alpha, beta, metric,
               kernel_policy, device="cuda", budget=None, seed_budget=None,
               seed_rounds: int = 4):
    from repro_torch.stream.weighted import (WeightedSummary,
                                             _min_argmin_bucketed,
                                             categorical_by_weight)

    x, w, orig, total = clean_weighted_input(points, weights, device)
    n = x.shape[0]
    if n == 0:
        return empty_summary(x.shape[1], x.device)
    b = int(budget) if budget is not None else default_budget(n, k, t)
    b = max(1, min(b, n))
    sb = int(seed_budget) if seed_budget is not None else max(2, 2 * k)
    sb = min(sb, n)
    rounds = max(1, min(int(seed_rounds), sb))
    ell = -(-sb // rounds)

    def dist(c_ids):
        return _min_argmin_bucketed(x, x[c_ids], metric=metric,
                                    policy=kernel_policy)

    # --- 1. weighted k-means|| seeding ---
    mind = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    seed_ids: list[torch.Tensor] = []
    key = sampler
    for r in range(rounds):
        key, sk = key.split(2)
        score = w if r == 0 else w * mind
        if float(score.sum()) <= 0.0:
            score = w
        pick = categorical_by_weight(sk, torch.clamp(score, min=_EPS), (ell,))
        seed_ids.append(pick)
        mind = torch.minimum(mind, dist(pick)[0])
    seeds = torch.unique(torch.cat(seed_ids))
    mind, amin = dist(seeds)
    amin = amin.long()

    # --- 2. sensitivities (float64) ---
    w64 = w.double()
    cluster_mass = torch.zeros((seeds.numel(),), dtype=torch.float64,
                               device=x.device).index_add_(0, amin, w64)
    wd = w64 * mind.double()
    sens = (wd / max(float(wd.sum()), _EPS)
            + w64 / (seeds.numel() * torch.clamp(cluster_mass[amin],
                                                 min=_EPS)))
    probs = sens / sens.sum()

    # --- 3. importance-sample the coreset ---
    key, sk = key.split(2)
    pick = categorical_by_weight(sk, torch.clamp(probs.float(), min=_EPS),
                                 (b,))
    uniq, counts = torch.unique(pick, return_counts=True)
    wts = counts.double() * w64[uniq] / (b * torch.clamp(probs[uniq],
                                                         min=_EPS))
    wts = wts * (total / max(float(wts.sum()), _EPS))   # exact conservation
    return WeightedSummary(points=x[uniq], weights=wts.float(),
                           is_candidate=torch.zeros(uniq.numel(),
                                                    dtype=torch.bool,
                                                    device=x.device),
                           n_rounds=rounds, total_weight=total,
                           indices=orig[uniq])


def default_budget(n: int, k: int, t: int) -> int:
    """Size-comparable with the paper summary: O(k log n) + the 8t slots
    Algorithm 1 would spend on candidates."""
    kappa = max(k, max(1, math.ceil(math.log(max(n, 2)))))
    return int(2 * kappa * max(1, math.ceil(math.log(max(n, 2)))) + 8 * t)


def _record_bound(params, *, k, t, alpha, beta, max_points, leaf_size):
    b = params.get("budget")
    if b is not None:
        return int(b) + 1
    return default_budget(int(max_points), k, t) + 1


register_summarizer(
    "coreset",
    summarize=_summarize,
    supports=lambda metric, k, t: True,
    priority=2,
    record_bound=_record_bound,
    description="k-means||-seeded sensitivity-sampling coreset "
                "(Dandolo et al. flavor); any metric incl. cosine",
    sized=True,
)
