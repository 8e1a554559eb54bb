"""The ``paper`` summarizer: Algorithm 1 / Algorithm 2 / the weighted path.

Port of ``repro.summarize.paper``.  Weighted path (stream leaves and
merges, the host-side coordinator):
``repro_torch.stream.weighted.weighted_summary_outliers`` — Algorithm 1
generalized to weighted records.  There is no weighted augmented variant
(Algorithm 2's reassignment needs the raw points), so ``variant`` only
affects the site path.

Site path: ``variant="auto"`` picks Algorithm 2 (augmented) when t >= 2k —
the t >> k regime where the 8t outlier candidates dwarf the O(k log n)
centers — and Algorithm 1 otherwise; ``"plain"`` / ``"augmented"`` force
one.  Cosine always routes to Algorithm 1 (the augmented reassignment's
far-away padding sentinel is meaningless under a direction-only metric).
"""
from __future__ import annotations

import math

from repro_torch.summarize.base import register_summarizer

AUGMENTED_T_OVER_K = 2  # variant="auto": augmented iff t >= this * k


def pick_augmented(variant: str, k: int, t: int, metric: str) -> bool:
    if variant not in ("auto", "plain", "augmented"):
        raise ValueError(f"unknown paper variant {variant!r}")
    if metric == "cosine":
        return False
    if variant != "auto":
        return variant == "augmented"
    return t >= AUGMENTED_T_OVER_K * k


def _summarize(points, weights, sampler, *, k, t, alpha, beta, metric,
               kernel_policy, device="cuda", variant: str = "auto"):
    from repro_torch.stream.weighted import weighted_summary_outliers

    return weighted_summary_outliers(points, weights, sampler, k=k, t=t,
                                     alpha=alpha, beta=beta, metric=metric,
                                     policy=kernel_policy, device=device)


def _site_summary(x, sampler, *, k, t, alpha, beta, metric, kernel_policy,
                  variant: str = "auto"):
    from repro_torch.core.augmented import augmented_summary_outliers
    from repro_torch.core.summary import summary_outliers

    fn = (augmented_summary_outliers if pick_augmented(variant, k, t, metric)
          else summary_outliers)
    return fn(x, sampler, k=k, t=t, alpha=alpha, beta=beta, metric=metric,
              policy=kernel_policy)


def _record_bound(params, *, k, t, alpha, beta, max_points, leaf_size):
    """Centers <= rounds * m, candidates <= 8t (unit-or-heavier weights).

    Rounds depend only on the total mass (<= max_points); one fixed-point
    pass accounts for merges seeing up to 2*cap records, which can only
    grow kappa (and m) logarithmically.
    """
    from repro_torch.stream.weighted import max_rounds

    rounds = max_rounds(float(max_points), t, beta)
    m = math.ceil(alpha * max(k, math.ceil(math.log(max(leaf_size, 2)))))
    cap = rounds * m + 8 * t + 1
    m = math.ceil(alpha * max(k, math.ceil(math.log(max(2 * cap, 2)))))
    return rounds * m + 8 * t + 1


register_summarizer(
    "paper",
    summarize=_summarize,
    site_summary=_site_summary,
    supports=lambda metric, k, t: True,
    priority=10,   # the paper's algorithm is the auto default everywhere
    record_bound=_record_bound,
    description="Summary-Outliers (Alg. 1/2; weighted for streams); "
                "site path auto-selects augmented when t >= 2k",
)
