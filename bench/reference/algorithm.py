"""Plain Algorithm 3 (Chen, Sadeqi Azer & Zhang 2018) in torch.

Written from the paper, with no kernels, no fixed-shape padding and no
registry: each site builds Summary-Outliers (Algorithm 1) augmented for
t >> k (Algorithm 2), the summaries are concatenated at the coordinator,
and weighted k-means-- (k-means++ seeding, then Lloyd steps that set the
farthest weight t aside) clusters them.  Distances are
||x||^2 + ||c||^2 - 2 x.c by a matrix product, in blocks of rows, in the
precision asked for: the control runs this file in the program's place
with TF32 matrix products.  Draws go through ``sampler.Sampler`` in the
order the paper's steps take them.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from bench.reference.sampler import Sampler

ALPHA, BETA = 2.0, 0.45
BLOCK_BYTES = 1 << 31


@contextlib.contextmanager
def matmul_tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def nearest(x: torch.Tensor, c: torch.Tensor, dtype=torch.float32):
    """(squared distance, index) of the nearest row of ``c`` for every row
    of ``x``, computed in ``dtype``; ties go to the smaller index."""
    x, c = x.to(dtype), c.to(dtype)
    c2 = (c * c).sum(1)
    rows = max(1, BLOCK_BYTES // (max(1, c.shape[0]) * c.element_size()))
    dist = torch.empty((x.shape[0],), dtype=dtype, device=x.device)
    idx = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], rows):
        xb = x[lo:lo + rows]
        # ||c||^2 - 2 x.c in one product; ||x||^2 does not move the argmin
        v, i = torch.addmm(c2[None, :], xb, c.T, alpha=-2.0).min(1)
        dist[lo:lo + rows] = (v + (xb * xb).sum(1)).clamp_(min=0.0)
        idx[lo:lo + rows] = i
    return dist, idx


def site_budget(t: int, s: int) -> int:
    """t_i = ceil(2t / s): the paper's local budget under a random
    partition."""
    return max(1, math.ceil(2 * t / s))


def plan(n: int, k: int, t: int):
    """(m, rounds): samples a round, m = alpha * max{k, log n}; rounds
    until |X_i| <= 8t, since each removes a beta share."""
    kappa = max(k, max(1, math.ceil(math.log(max(n, 2)))))
    m = max(1, math.ceil(ALPHA * kappa))
    stop = max(8 * t, 1)
    rounds = 0 if n <= stop else max(
        1, math.ceil(math.log(n / stop) / -math.log1p(-BETA)))
    return m, rounds


def summary_outliers(x, sampler, *, k, t, dtype=torch.float32):
    """Algorithm 1: (candidate mask X_r, center mask S) over x's rows."""
    n = x.shape[0]
    m, rounds = plan(n, k, t)
    active = torch.ones((n,), dtype=torch.bool, device=x.device)
    centers = torch.zeros((n,), dtype=torch.bool, device=x.device)
    key, cnt = sampler, n
    for _ in range(rounds):
        if cnt <= 8 * t:
            break
        key, sk = key.split(2)
        # line 6: m samples, uniform with replacement, from X_i
        idx = sk.categorical(torch.where(active, 0.0, float("-inf")), (m,))
        # lines 7-8: the smallest radius whose balls hold a beta share of X_i
        dist, _ = nearest(x, x[idx], dtype)
        dist = torch.where(active, dist.float(), float("inf"))
        rho = torch.kthvalue(dist, min(max(math.ceil(BETA * cnt), 1),
                                       cnt)).values
        centers[idx] = True
        active &= ~(dist <= rho)
        cnt = int(active.sum())
    return active, centers


def augmented_summary(x, sampler, *, k, t, dtype=torch.float32):
    """Algorithm 2 on one site: (record ids, weights, candidate flags)."""
    n = x.shape[0]
    _, k1, k2 = sampler.split(3)
    cand, centers = summary_outliers(x, k1, k=k, t=t, dtype=dtype)
    # line 2: |X_r| - |S| more centers from X \ (X_r u S)
    need = max(int(cand.sum()) - int(centers.sum()), 0)
    free = ~(cand | centers)
    logits = (torch.where(free, 0.0, float("-inf")) if bool(free.any())
              else torch.zeros((n,), device=x.device))
    extra = k2.categorical(logits, (8 * t + 1,))[:need]
    centers = centers.clone()
    centers[extra] = True
    # line 3: every row outside X_r to its nearest center of S u S'
    c_ids = torch.nonzero(centers).flatten()
    _, near = nearest(x, x[c_ids], dtype)
    owner = torch.where(cand, torch.arange(n, device=x.device), c_ids[near])
    # line 4: weights under that map
    w = torch.bincount(owner, minlength=n).float()
    ids = torch.nonzero(centers | cand).flatten()
    return ids, w[ids], cand[ids]


def greedy_outliers(dist, w, t):
    """The farthest records, by distance, whose weights add up to at most
    t (stable: equal distances keep index order)."""
    order = torch.argsort(-dist, stable=True)
    ws = w[order]
    flag = (torch.cumsum(ws, 0) <= t) & (ws > 0)
    out = torch.zeros_like(flag)
    out[order] = flag
    return out


def kmeans_mm(points, w, sampler, *, k, t, iters, dtype=torch.float32):
    """Weighted k-means--: k-means++ D^2 seeding, ``iters`` Lloyd steps
    with the farthest weight t set aside, then the final assignment.
    Returns (centers, outlier mask, cost)."""
    n = points.shape[0]
    mind = torch.full((n,), float("inf"), dtype=dtype, device=points.device)
    picks, key = [], sampler
    for _ in range(k):
        key, sk = key.split(2)
        score = torch.where(torch.isinf(mind), w, w * mind)
        score = score if float(score.sum()) > 0 else w
        logits = torch.where(w > 0, torch.log(torch.clamp(score, min=1e-30)),
                             float("-inf"))
        i = sk.categorical(logits)
        mind = torch.minimum(mind, nearest(points, points[i][None],
                                           dtype)[0])
        picks.append(int(i))
    c = points[picks].to(dtype)
    for _ in range(iters):
        dist, near = nearest(points, c, dtype)
        out = greedy_outliers(dist, w, t)
        onehot = (near[:, None] == torch.arange(k, device=points.device)
                  ).to(dtype) * (w * ~out)[:, None]
        sums = onehot.T @ points.to(dtype)
        cnt = onehot.sum(0)
        c = torch.where(cnt[:, None] > 0,
                        sums / torch.clamp(cnt, min=1e-9)[:, None], c)
    dist, _ = nearest(points, c, dtype)
    out = greedy_outliers(dist, w, t)
    return c, out, float(torch.sum(torch.where(out, 0.0, dist) * w))


def fit(x: torch.Tensor, cfg: dict, seed: int, *, tf32: bool = False):
    """Algorithm 3 over ``cfg["sites"]`` contiguous parts of ``x``; returns
    what the program's fit returns (numpy ids global)."""
    s, k, t = int(cfg["sites"]), int(cfg["k"]), int(cfg["t"])
    t_i = site_budget(t, s)
    sampler = Sampler(seed)
    ids, ws, cands = [], [], []
    off = 0
    with matmul_tf32(tf32):
        for i, part in enumerate(torch.tensor_split(x, s)):
            a, b, c = augmented_summary(part, sampler.fold_in(i), k=k, t=t_i)
            ids.append(a + off)
            ws.append(b)
            cands.append(c)
            off += part.shape[0]
        ids, w = torch.cat(ids), torch.cat(ws)
        centers, out, cost = kmeans_mm(
            x[ids], w, sampler.fold_in(2**31 - 1), k=k, t=float(t),
            iters=int(cfg["second_iters"]))
    return {
        "centers": centers.cpu().numpy(),
        "outlier_ids": ids[out].cpu().numpy(),
        "summary_ids": ids.cpu().numpy(),
        "summary_weights": w.cpu().numpy(),
        "summary_candidates": torch.cat(cands).cpu().numpy(),
        "comm_records": float(ids.numel()),
        "cost": cost,
    }


def site_sizes(n: int, s: int) -> np.ndarray:
    """Rows of each of s contiguous sites (``torch.tensor_split``'s)."""
    q, r = divmod(n, s)
    return np.array([q + 1] * r + [q] * (s - r))
