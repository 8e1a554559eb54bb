"""Weighted Summary-Outliers: Algorithm 1 generalized to weighted inputs.

Port of ``repro.stream.weighted``.  A record (x, w) stands for w coincident
unit points.  Two changes from the unit-weight algorithm in
``repro_torch.core.summary``:

* Line 6 samples the m round-samples with probability proportional to
  weight (a record of weight w is w times as likely as a unit record);
* Line 8 grows the ball to the smallest radius rho_i whose captured
  *weight mass* reaches beta * W_i (W_i = total remaining weight), and the
  stopping rule |X_i| <= 8t becomes W_i <= 8t.

With unit weights both rules reduce exactly to the paper's.  Every round
removes at least a beta fraction of the remaining *mass*, so the loop runs
at most ceil(log(W/8t) / -log(1-beta)) rounds.  A weighted summary
conserves mass, so summaries of summaries compose (merge-and-reduce).

The reference keeps its set logic in numpy and pads every distance call to
a power-of-two row bucket so that jit compiles once per bucket.  The port
keeps tensors on the caller's device and does the set logic there in torch
(stable ``argsort``, ``cumsum``, ``searchsorted``, ``index_add_``,
``unique``); torch does not retrace, and a row's min and argmin do not
depend on the other rows, so the distance calls take the real rows only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.sampler import Sampler
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin


def _bucket(n: int, lo: int = 256) -> int:
    """Next power-of-two >= n (min lo).  The reference bounds its jit shapes
    with it; here it sets the length of the logits a weighted draw hands the
    sampler (see :func:`categorical_by_weight`)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def categorical_by_weight(sampler: Sampler, w: torch.Tensor,
                          shape) -> torch.Tensor:
    """int64 ids (with replacement) with probability ∝ ``w`` (all > 0).

    The logits are ``log(w)`` padded with -inf to ``_bucket(len(w))``, as
    the reference pads them: a Gumbel draw is made per logit, so the padded
    length decides the numbers drawn, and the replaying sampler must see
    the same vector.
    """
    logits = torch.full((_bucket(w.numel()),), float("-inf"),
                        dtype=torch.float32, device=w.device)
    logits[:w.numel()] = torch.log(w.float())
    return sampler.categorical(logits, tuple(shape))


def _min_argmin_bucketed(xr: torch.Tensor, c: torch.Tensor, *, metric: str,
                         policy: Optional[KernelPolicy]):
    """``min_argmin`` of the reference's bucketed call.  The reference pads
    ``xr`` with 1e30 rows to a power-of-two count so that jit compiles once
    per bucket; each row's result depends on that row alone, so the port
    calls ``min_argmin`` on the real rows.  (The CUDA kernels give each row
    the same bits at any row count; the plain CPU path's matmul picks its
    blocking by shape and may round a row's dot product otherwise.)"""
    return min_argmin(xr, c, metric=metric, policy=policy)


class WeightedSummary(NamedTuple):
    """Compact (no padding) weighted summary of a weighted point set.

    points       (s, d) f32  — summary points (subset of the input rows)
    weights      (s,) f32    — mass mapped to each point; conserves input mass
    is_candidate (s,) bool   — True for survivors X_r (outlier candidates)
    n_rounds     int         — rounds the ball-growing loop ran
    total_weight float       — input mass (== weights.sum() up to fp error)
    indices      (s,) int64 | None — row ids of the summary points in the
                 summarizer's *input* (ids of the caller's rows, also after
                 zero-weight rows are dropped).  None once the provenance is
                 lost (merges).
    """

    points: torch.Tensor
    weights: torch.Tensor
    is_candidate: torch.Tensor
    n_rounds: int
    total_weight: float
    indices: Optional[torch.Tensor] = None


def max_rounds(total_weight: float, t: int, beta: float) -> int:
    """Deterministic round bound: each round captures >= beta of the mass."""
    stop = max(8 * t, 1)
    if total_weight <= stop:
        return 0
    return max(1, int(math.ceil(math.log(total_weight / stop)
                                / -math.log1p(-beta))))


def ball_round(x, w, remaining, sampler: Sampler, *, m: int, beta: float,
               metric: str, policy):
    """One round of the weighted ball growing, shared with ``ball_cover``.

    Returns ``(idx, wr, amin, captured)``: the global ids of the round's m
    samples (drawn ∝ weight), the remaining weights, each remaining row's
    nearest sample and the rows within the smallest radius whose captured
    mass reaches ``beta`` of the remaining mass.
    """
    wr = w[remaining]
    # Line 6 (weighted): sample m records with replacement, p ∝ weight.
    idx = remaining[categorical_by_weight(sampler, wr, (m,))]
    mind, amin = _min_argmin_bucketed(x[remaining], x[idx], metric=metric,
                                      policy=policy)
    # Line 8 (weighted): smallest rho capturing >= beta * W_i of mass.  The
    # reference's searchsorted compares its f32 sums with a float64 value.
    order = torch.argsort(mind, stable=True)
    cumw = torch.cumsum(wr[order], dim=0)
    goal = torch.tensor([beta * float(wr.sum())], dtype=torch.float64,
                        device=cumw.device)
    kpos = min(int(torch.searchsorted(cumw.double(), goal)), order.numel() - 1)
    rho = mind[order[kpos]]
    captured = mind <= rho                # samples sit at rho=0: always in
    return idx, wr, amin.long(), captured


def _finish(x, w, orig, total, acc_w, center_ids, remaining, rounds):
    """The summary: centers that carry mass, then the survivors."""
    dev = x.device
    centers = (torch.unique(torch.cat(center_ids)) if center_ids
               else torch.empty((0,), dtype=torch.int64, device=dev))
    # coincident sampled points can tie on argmin so one of them captures
    # all the mass; drop the zero-mass twins to keep the weights>0 invariant
    centers = centers[acc_w[centers] > 0]
    sel = torch.cat([centers, remaining])
    cand = torch.cat([torch.zeros(centers.numel(), dtype=torch.bool,
                                  device=dev),
                      torch.ones(remaining.numel(), dtype=torch.bool,
                                 device=dev)])
    return WeightedSummary(points=x[sel],
                           weights=torch.cat([acc_w[centers], w[remaining]]),
                           is_candidate=cand, n_rounds=rounds,
                           total_weight=total, indices=orig[sel])


def weighted_rounds(points, weights, sampler: Sampler, *, k: int, t: int,
                    alpha: float, beta: float, metric: str, policy,
                    device, assign) -> WeightedSummary:
    """Algorithm 1's weighted loop, shared with ``ball_cover``: rounds of
    :func:`ball_round` until the remaining mass is at most 8t.

    ``assign(x, idx, wr, amin, captured, remaining, acc_w)`` adds the
    round's captured mass into ``acc_w`` and returns the ids of the round's
    centers; it is the only step in which the summarizers differ.
    """
    from repro_torch.summarize.base import clean_weighted_input, empty_summary

    policy = resolve_policy(policy)
    x, w, orig, total = clean_weighted_input(points, weights, device)
    n = x.shape[0]
    if n == 0:
        return empty_summary(x.shape[1], x.device)

    kappa = max(k, max(1, math.ceil(math.log(max(n, 2)))))
    m = max(1, int(math.ceil(alpha * kappa)))
    stop = max(8 * t, 1)
    bound = max_rounds(total, t, beta) + 4  # +4: fp slack on the mass sums

    remaining = torch.arange(n, dtype=torch.int64, device=x.device)
    acc_w = torch.zeros((n,), dtype=torch.float32, device=x.device)
    center_ids: list[torch.Tensor] = []
    rounds = 0
    key = sampler
    while (remaining.numel() and float(w[remaining].sum()) > stop
           and rounds < bound):
        key, sk = key.split(2)
        idx, wr, amin, captured = ball_round(x, w, remaining, sk, m=m,
                                             beta=beta, metric=metric,
                                             policy=policy)
        center_ids.append(assign(x, idx, wr, amin, captured, remaining,
                                 acc_w))
        remaining = remaining[~captured]
        rounds += 1
    return _finish(x, w, orig, total, acc_w, center_ids, remaining, rounds)


def _assign_nearest(x, idx, wr, amin, captured, remaining, acc_w):
    """Line 9: each captured record's full mass goes to its nearest sample."""
    acc_w.index_add_(0, idx[amin[captured]], wr[captured])
    return torch.unique(idx)


def weighted_summary_outliers(
    points,
    weights,
    sampler: Sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
    device="cuda",
) -> WeightedSummary:
    """Weighted Summary-Outliers over records (points[i], weights[i]), on the
    device of ``points`` when it is a tensor, else on ``device``."""
    return weighted_rounds(points, weights, sampler, k=k, t=t, alpha=alpha,
                           beta=beta, metric=metric, policy=policy,
                           device=device, assign=_assign_nearest)


def merge_summaries(summaries: Sequence[WeightedSummary]) -> WeightedSummary:
    """Concatenate weighted summaries (the 'merge' half of merge-and-reduce).

    Pure union — no information is lost; mass is conserved exactly.
    """
    live = [s for s in summaries if s.points.shape[0]]
    if not live:
        return WeightedSummary(torch.zeros((0, 0)), torch.zeros((0,)),
                               torch.zeros((0,), dtype=torch.bool), 0, 0.0)
    return WeightedSummary(
        points=torch.cat([s.points for s in live]),
        weights=torch.cat([s.weights for s in live]),
        is_candidate=torch.cat([s.is_candidate for s in live]),
        n_rounds=max(s.n_rounds for s in live),
        total_weight=float(sum(s.total_weight for s in live)),
    )


def resummarize(
    summaries: Sequence[WeightedSummary],
    sampler: Sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[KernelPolicy] = None,
) -> WeightedSummary:
    """The 'reduce' half: weighted Summary-Outliers on the merged union.

    Keeps the full outlier budget t at every level so that up to t true
    outliers survive as candidates through any number of merges.
    """
    merged = merge_summaries(summaries)
    if merged.points.shape[0] == 0:
        return merged
    return weighted_summary_outliers(
        merged.points, merged.weights, sampler, k=k, t=t, alpha=alpha,
        beta=beta, metric=metric, policy=policy)
