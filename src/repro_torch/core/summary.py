"""Algorithm 1 (Summary-Outliers) from Chen, Sadeqi Azer & Zhang (2018).

Port of ``repro.core.summary``, with the same two implementations:

* ``summary_outliers``         — fixed-capacity masked state: the remainder
  X_i is a mask over all n points, so every round scores all n rows
  (O(R·n·m) distance work) and the summary has a static capacity.
* ``summary_outliers_compact`` — physically compacts X_i between rounds,
  the paper's O(n·m) total work.

Both draw through a :class:`~repro_torch.core.sampler.Sampler` in the
reference's key schedule, so under a replaying sampler they reproduce the
reference's summaries exactly.

Notation maps 1:1 to the paper: kappa = max{k, log n}; each round samples
``m = alpha*kappa`` points S_i from the remainder X_i, grows balls of the
smallest radius rho_i capturing a beta fraction, assigns captured points to
their nearest sample (sigma), and recurses.  Stops when |X_i| <= 8t; the
survivors X_r are the outlier *candidates* (weight 1), the samples are the
summary centers (weight = |sigma^{-1}|).  beta defaults to 0.45 (the paper
prints 4.5; Algorithm 1 requires 0.25 <= beta < 0.5).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sampler import Sampler
from repro_torch.kernels.dispatch import KernelPolicy, resolve_policy
from repro_torch.kernels.pdist.ops import min_argmin


class Summary(NamedTuple):
    """Fixed-capacity weighted summary Q of a dataset X.

    indices      (cap,) int32  — index into the original X; == n for padding
    points       (cap, d) f32  — the summary points (zeros for padding)
    weights      (cap,) f32    — |sigma^{-1}(x)|; 0 for padding
    is_candidate (cap,) bool   — True for X_r members (outlier candidates)
    valid        (cap,) bool   — real entry vs padding
    sigma        (n,) int32    — the paper's mapping sigma: X -> X
    n_rounds     int           — r
    n_remaining  int           — |X_r|
    """

    indices: torch.Tensor
    points: torch.Tensor
    weights: torch.Tensor
    is_candidate: torch.Tensor
    valid: torch.Tensor
    sigma: torch.Tensor
    n_rounds: int
    n_remaining: int

    @property
    def size(self):
        return self.valid.sum()


def _plan(n: int, k: int, t: int, alpha: float, beta: float):
    """Static (python) round/capacity plan. Deterministic upper bounds:
    each round removes >= ceil(beta*|X_i|) points, so
    |X_i| <= n*(1-beta)^i and R = ceil(log(n/max(8t,1)) / -log(1-beta))."""
    kappa = max(k, max(1, math.ceil(math.log(max(n, 2)))))
    m = max(1, int(math.ceil(alpha * kappa)))
    stop = max(8 * t, 1)
    if n <= stop:
        rounds = 0
    else:
        rounds = max(1, int(math.ceil(math.log(n / stop) / -math.log1p(-beta))))
    cap = min(n, rounds * m + 8 * t + 1)
    return kappa, m, rounds, cap


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int64 ids of the True entries of ``mask``, in order, cut or padded
    with ``fill`` to ``size`` (``jnp.nonzero(mask, size=, fill_value=)``)."""
    ids = torch.nonzero(mask).flatten()[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    out[:ids.numel()] = ids
    return out


def _kth_rank(beta: float, cnt: int) -> int:
    """ceil(beta * cnt) clipped to [1, cnt], in float32 as the reference's
    traced ``jnp.ceil(beta * cnt)`` computes it."""
    v = math.ceil(float(np.float32(beta) * np.float32(cnt)))
    return int(min(max(v, 1), cnt))


def summary_outliers(
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
    """Fixed-shape Summary-Outliers (Algorithm 1) on ``x``'s device."""
    policy = resolve_policy(policy)
    n, d = x.shape
    dev = x.device
    _, m, rounds, cap = _plan(n, k, t, alpha, beta)
    stop = 8 * t

    arange = torch.arange(n, dtype=torch.int32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    sigma = arange.clone()
    center_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    key = sampler
    i = 0
    cnt = n
    while i < rounds and cnt > stop:
        with obs.span("alg1.round", round=i):
            key, sk = key.split(2)
            # Line 6: sample m points (with replacement) uniformly from X_i.
            logits = torch.where(active, 0.0, float("-inf"))
            idx = sk.categorical(logits, (m,), caller="alg1.sample")
            # Line 7: nearest-sample distance for every remaining point.
            with obs.span("alg1.distance"):
                mind, amin = min_argmin(x, x[idx], metric=metric,
                                        policy=policy)
            with obs.span("alg1.radius"):
                masked = torch.where(active, mind, float("inf"))
                # Line 8: smallest rho with |B(S_i, X_i, rho)| >= beta*|X_i|.
                rho = torch.kthvalue(masked, _kth_rank(beta, cnt)).values
                captured = active & (mind <= rho)
                # Line 9: sigma(x) <- nearest sample, as a global index.
                sigma = torch.where(captured,
                                    idx[amin.long()].to(torch.int32), sigma)
                center_mask[idx] = True
                active = active & ~captured
            i += 1
            with obs.span("alg1.readback"):
                cnt = int(active.sum())

    # Line 13: survivors map to themselves.
    sigma = torch.where(active, arange, sigma)
    # Line 14: weights w_x = |sigma^{-1}(x)| (adds of 1.0: exact in any order).
    w = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
        0, sigma.long(), torch.ones((n,), dtype=torch.float32, device=dev))

    idx_q = nonzero_fixed(center_mask | active, cap, n)
    xp = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=dev)])
    wp = torch.cat([w, torch.zeros((1,), dtype=torch.float32, device=dev)])
    cand = torch.cat([active, torch.zeros((1,), dtype=torch.bool, device=dev)])
    return Summary(
        indices=idx_q.to(torch.int32),
        points=xp[idx_q],
        weights=wp[idx_q],
        is_candidate=cand[idx_q],
        valid=idx_q < n,
        sigma=sigma,
        n_rounds=i,
        n_remaining=cnt,
    )


def summary_outliers_compact(
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
    """Summary-Outliers that compacts X_i between rounds.

    Work matches the paper's O(max{k, log n} * n): the i-th round touches
    |X_i| <= n(1-beta)^i points.
    """
    policy = resolve_policy(policy)
    n, d = x.shape
    dev = x.device
    _, m, _, _ = _plan(n, k, t, alpha, beta)
    stop = max(8 * t, 1)

    remaining = torch.arange(n, dtype=torch.int64, device=dev)  # ids of X_i
    sigma = torch.arange(n, dtype=torch.int64, device=dev)
    center_ids: list[torch.Tensor] = []
    rounds = 0
    key = sampler
    while remaining.numel() > stop:
        with obs.span("alg1.round", round=rounds):
            key, sk = key.split(2)
            size = remaining.numel()
            idx = remaining[sk.randint(size, (m,), device=dev,
                                       caller="alg1.sample")]
            with obs.span("alg1.distance"):
                mind, amin = min_argmin(x[remaining], x[idx], metric=metric,
                                        policy=policy)
            with obs.span("alg1.radius"):
                kth = int(np.clip(np.ceil(beta * size), 1, size))
                rho = torch.kthvalue(mind, kth).values
                captured = mind <= rho
            # the boolean indexing waits for the card
            with obs.span("alg1.readback"):
                sigma[remaining[captured]] = idx[amin[captured].long()]
                center_ids.append(idx)
                remaining = remaining[~captured]
            rounds += 1

    sigma[remaining] = remaining
    w = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
        0, sigma, torch.ones((n,), dtype=torch.float32, device=dev))
    centers = (torch.unique(torch.cat(center_ids)) if center_ids
               else torch.empty((0,), dtype=torch.int64, device=dev))
    is_cand = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_cand[remaining] = True
    sel = torch.unique(torch.cat([centers, remaining]))
    return Summary(
        indices=sel.to(torch.int32),
        points=x[sel],
        weights=w[sel],
        is_candidate=is_cand[sel],
        valid=torch.ones((sel.numel(),), dtype=torch.bool, device=dev),
        sigma=sigma.to(torch.int32),
        n_rounds=rounds,
        n_remaining=int(remaining.numel()),
    )


def information_loss(x: torch.Tensor, sigma: torch.Tensor,
                     metric: str = "l2sq"):
    """loss(Q) = phi_X(sigma) = sum_x d(x, sigma(x))  (Definition 2)."""
    delta = x - x[sigma.long()]
    if metric == "l1":
        return delta.abs().sum()
    sq = (delta * delta).sum(-1)
    return sq.sum() if metric == "l2sq" else torch.sqrt(sq).sum()
