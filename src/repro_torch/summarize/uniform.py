"""The ``uniform`` summarizer: weighted reservoir sampling baseline.

Port of ``repro.summarize.uniform``.  Generalizes
``repro_torch.core.rand_summary`` (the paper's ``rand`` baseline) to
weighted inputs: sample ``budget`` records without replacement with
inclusion probability ∝ weight (the Efraimidis–Spirakis exponential-key
reservoir, in log space), then assign every input record's full mass to
its nearest sample — so the output conserves mass exactly.

The keys are ``log(u) / w`` in float64 from float32 uniforms, so at a
large site equal keys are common.  The reference's ``argpartition`` breaks
a tie at the ``budget``-th key in no specified way; the port takes the
largest keys and, among equal keys, the smallest row ids, so its choice is
deterministic.  A tie exactly at that boundary may therefore pick another
row than the reference.

No outlier candidates: this is why the baseline fails at outlier detection
in the paper's Tables 2–4.  Never auto-picked (priority < 0).
"""
from __future__ import annotations

import torch

from repro_torch.summarize.base import (clean_weighted_input, empty_summary,
                                        register_summarizer)


def default_budget(n: int, k: int, t: int) -> int:
    """The paper's baseline budget O(k log n + t)."""
    from repro_torch.core.kmeans_pp import pp_budget

    return pp_budget(n, k, t)


def reservoir_ids(u: torch.Tensor, w: torch.Tensor, b: int) -> torch.Tensor:
    """Sorted ids of the ``b`` largest keys ``log(u) / w`` (float64), equal
    keys taken in row order."""
    keys = torch.log(u.double()) / w.double()
    return torch.sort(torch.argsort(-keys, stable=True)[:b]).values


def _summarize(points, weights, sampler, *, k, t, alpha, beta, metric,
               kernel_policy, device="cuda", budget=None):
    from repro_torch.stream.weighted import (WeightedSummary,
                                             _min_argmin_bucketed)

    x, w, orig, total = clean_weighted_input(points, weights, device)
    n = x.shape[0]
    if n == 0:
        return empty_summary(x.shape[1], x.device)
    b = int(budget) if budget is not None else default_budget(n, k, t)
    b = max(1, min(b, n))
    if b == n:
        idx = torch.arange(n, device=x.device)
    else:
        # A-ES reservoir keys u^(1/w): maximize log(u)/w instead (log u < 0)
        u = sampler.uniform((n,), 1e-12, 1.0, device=x.device)
        idx = reservoir_ids(u, w, b)
    _, amin = _min_argmin_bucketed(x, x[idx], metric=metric,
                                   policy=kernel_policy)
    acc = torch.zeros((b,), dtype=torch.float32, device=x.device)
    acc.index_add_(0, amin.long(), w)
    live = acc > 0   # coincident samples can tie to zero mass; drop them
    return WeightedSummary(points=x[idx[live]], weights=acc[live],
                           is_candidate=torch.zeros(int(live.sum()),
                                                    dtype=torch.bool,
                                                    device=x.device),
                           n_rounds=1, total_weight=total,
                           indices=orig[idx[live]])


def _site_summary(x, sampler, *, k, t, alpha, beta, metric, kernel_policy,
                  budget=None):
    from repro_torch.core.rand_summary import rand_summary

    n = int(x.shape[0])
    b = int(budget) if budget is not None else default_budget(n, k, t)
    return rand_summary(x, sampler, budget=max(1, min(b, n)), metric=metric,
                        policy=kernel_policy)


def _record_bound(params, *, k, t, alpha, beta, max_points, leaf_size):
    b = params.get("budget")
    if b is not None:
        return int(b) + 1
    return default_budget(int(max_points), k, t) + 1


register_summarizer(
    "uniform",
    summarize=_summarize,
    site_summary=_site_summary,
    supports=lambda metric, k, t: True,
    priority=-1,   # baseline: by name only, never auto-picked
    record_bound=_record_bound,
    description="weighted reservoir sample + nearest-sample mass "
                "(the paper's rand baseline); no outlier candidates",
    sized=True,
)
