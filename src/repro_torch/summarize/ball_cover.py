"""The ``ball_cover`` summarizer: heavy-noise-robust ball-cover aggregation.

Port of ``repro.summarize.ball_cover``.  In the heavy-noise regime
(t >> k) Algorithm 1 samples noise points in proportion to their mass, and
every sampled point becomes a center, so the summary fills up with
singleton noise balls.  Guo & Li (arXiv:1810.07852) aggregate the cover:
only balls that capture a non-trivial mass survive as centers.

This keeps Algorithm 1's weighted loop (``stream.weighted.weighted_rounds``:
sample m records ∝ weight, grow the shared radius to capture a beta
fraction of the remaining mass — so the round bound is untouched) and
replaces its Line-9 assignment with the aggregation step:

  * a sampled ball is **heavy** when it captures at least
    ``min_ball_frac * beta * W_i / m`` mass;
  * captured records whose nearest sample is *light* are re-routed to
    their nearest **heavy** sample (a second ``min_argmin`` over <= m
    centers), and only heavy samples survive as summary centers.

Survivors of the final round are outlier candidates (mass <= 8t), as in
the paper summarizer.
"""
from __future__ import annotations

import torch

from repro_torch.summarize.base import register_summarizer


def _summarize(points, weights, sampler, *, k, t, alpha, beta, metric,
               kernel_policy, device="cuda", min_ball_frac: float = 0.5):
    from repro_torch.stream.weighted import (_min_argmin_bucketed,
                                             weighted_rounds)

    def fold_light(x, idx, wr, amin, captured, remaining, acc_w):
        m = idx.numel()
        ball_mass = torch.zeros((m,), dtype=torch.float32, device=x.device)
        ball_mass.index_add_(0, amin[captured], wr[captured])
        heavy = ball_mass >= min_ball_frac * beta * float(wr.sum()) / m
        n_heavy = int(heavy.sum())
        if not 0 < n_heavy < m:
            # no ball stands out (or all do): plain Algorithm 1 assignment
            acc_w.index_add_(0, idx[amin[captured]], wr[captured])
            return torch.unique(idx)
        light_pt = captured & ~heavy[amin]
        if bool(light_pt.any()):
            _, re_amin = _min_argmin_bucketed(
                x[remaining[light_pt]], x[idx[heavy]], metric=metric,
                policy=kernel_policy)
            acc_w.index_add_(0, idx[heavy][re_amin.long()], wr[light_pt])
        kept = captured & heavy[amin]
        acc_w.index_add_(0, idx[amin[kept]], wr[kept])
        return torch.unique(idx[heavy])

    return weighted_rounds(points, weights, sampler, k=k, t=t, alpha=alpha,
                           beta=beta, metric=metric, policy=kernel_policy,
                           device=device, assign=fold_light)


def _record_bound(params, *, k, t, alpha, beta, max_points, leaf_size):
    # never more centers than the paper summarizer (a subset of its samples)
    from repro_torch.summarize.paper import _record_bound as paper_bound

    return paper_bound({}, k=k, t=t, alpha=alpha, beta=beta,
                       max_points=max_points, leaf_size=leaf_size)


register_summarizer(
    "ball_cover",
    summarize=_summarize,
    supports=lambda metric, k, t: True,
    priority=5,    # auto falls back here only if paper ever opts out
    record_bound=_record_bound,
    description="Guo & Li-style ball-cover aggregation: light balls fold "
                "into heavy ones, robust to heavy (t >> k) noise",
)
