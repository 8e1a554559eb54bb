"""Algorithm 3 (Distributed-Median/Means) in the coordinator model.

Port of ``repro.core.distributed``'s host-driven path,
``simulate_coordinator``: each site builds its local summary with
Summary-Outliers(A_i, k, t_i) (Algorithm 1, augmented by Algorithm 2 by
default), the summaries are gathered once, and the second-level weighted
k-means-- runs at the coordinator.  Communication is the number of summary
records gathered.

Partition modes: ``random`` uses the paper's local budget t_i = 2t/s
(Chernoff: all sites respect it w.h.p.); ``adversarial`` uses t_i = t.

``summarizer=`` runs any algorithm of the ``repro_torch.summarize``
registry per site through its weighted entry point (unit weights).

Not ported yet (ROADMAP.md): the collective ``distributed_cluster``.
"""
from __future__ import annotations

import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.augmented import augmented_summary_outliers
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import summary_outliers, summary_outliers_compact
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.summarize.base import SummarizerPolicy, summarize


def local_budget(t: int, s: int, partition: str) -> int:
    if partition == "adversarial":
        return t
    return max(1, int(math.ceil(2 * t / s)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def simulate_coordinator(
    parts: Sequence,
    sampler: Sampler,
    *,
    k: int,
    t: int,
    partition: str = "random",
    summary_alg: str = "augmented",
    summarizer: SummarizerPolicy | None = None,
    second_iters: int = 25,
    metric: str = "l2sq",
    policy: KernelPolicy | None = None,
    compact: bool = True,
    device="cuda",
):
    """Host-side Algorithm 3 over a list of per-site arrays (numpy arrays
    or tensors; each is moved to ``device``).

    Returns the reference's result dict (numpy ``centers``,
    ``outlier_ids``, ``summary_ids``, ``summary_weights``,
    ``summary_candidates``; float ``comm_records`` and ``cost``) plus
    ``site_records`` (records each site sent), ``site_rounds`` (Alg. 1
    rounds per site; a registry summary's ``n_rounds``) and ``phase_s``
    (wall seconds of the site summaries and of the second level, each
    ended by a device synchronisation).
    Global ids are offsets into the concatenation of ``parts``.

    ``summarizer`` (a ``SummarizerPolicy``) runs that registered algorithm
    per site through its weighted entry point with unit weights; None
    keeps the ``summary_alg`` / ``compact`` selection, bit for bit.
    """
    if summary_alg not in ("augmented", "plain"):
        raise ValueError(f"unknown summary_alg {summary_alg!r}")
    dev = resolve_device(device)
    s = len(parts)
    t_i = local_budget(t, s, partition)
    offs = np.cumsum([0] + [p.shape[0] for p in parts])

    all_pts, all_w, all_gid, all_cand, rounds = [], [], [], [], []
    t0 = time.perf_counter()
    for i, part in enumerate(parts):
        x = torch.as_tensor(part, dtype=torch.float32, device=dev)
        skey = sampler.fold_in(i)
        if summarizer is not None:
            ws = summarize(x, torch.ones((x.shape[0],), device=dev), skey,
                           k=k, t=t_i, metric=metric, policy=summarizer,
                           kernel_policy=policy)
            all_pts.append(ws.points)
            all_w.append(ws.weights)
            all_gid.append(ws.indices + int(offs[i]))
            all_cand.append(ws.is_candidate)
            rounds.append(ws.n_rounds)
            continue
        if summary_alg == "augmented":
            summ = augmented_summary_outliers(x, skey, k=k, t=t_i,
                                              metric=metric, policy=policy)
        elif compact:
            summ = summary_outliers_compact(x, skey, k=k, t=t_i,
                                            metric=metric, policy=policy)
        else:
            summ = summary_outliers(x, skey, k=k, t=t_i, metric=metric,
                                    policy=policy)
        valid = summ.valid
        all_pts.append(summ.points[valid])
        all_w.append(summ.weights[valid])
        all_gid.append(summ.indices[valid].long() + int(offs[i]))
        all_cand.append(summ.is_candidate[valid])
        rounds.append(int(summ.n_rounds))
    _sync(dev)
    t1 = time.perf_counter()
    res = coordinator_fit(all_pts, all_w, all_gid, all_cand, rounds, sampler,
                          k=k, t=t, second_iters=second_iters, metric=metric,
                          policy=policy)
    t2 = time.perf_counter()
    res["phase_s"] = {"site_summaries": t1 - t0, "second_level": t2 - t1}
    return res


def coordinator_fit(points, weights, gids, candidates, rounds,
                    sampler: Sampler, *, k: int, t: int, second_iters: int = 25,
                    metric: str = "l2sq", policy: KernelPolicy | None = None):
    """Algorithm 3's coordinator: gather the per-site summaries once and fit
    the weighted k-means-- on their union.

    ``points``, ``weights``, ``gids`` (global row ids) and ``candidates``
    hold one tensor per site, ``rounds`` one int per site.  The second
    level draws from ``sampler.fold_in(2**31 - 1)``.  Returns the result
    dict of :func:`simulate_coordinator` without ``phase_s``; the device
    work is finished when it returns.
    """
    # each site "sends" exactly its live summary records to the coordinator
    pts = torch.cat(points).float()
    wts = torch.cat(weights).float()
    n_rec = pts.shape[0]
    sol = kmeans_minus_minus(pts, wts,
                             torch.ones((n_rec,), dtype=torch.bool,
                                        device=pts.device),
                             sampler.fold_in(2**31 - 1), k=k, t=float(t),
                             iters=second_iters, metric=metric, policy=policy)
    centers = sol.centers.cpu().numpy()
    out_mask = sol.outlier.cpu().numpy()
    cost = float(sol.cost)
    gid = torch.cat(gids).cpu().numpy()
    return {
        "centers": centers,
        "outlier_ids": gid[out_mask],
        "summary_ids": gid,
        "summary_weights": wts.cpu().numpy(),
        "summary_candidates": torch.cat(candidates).cpu().numpy(),
        "comm_records": float(n_rec),
        "cost": cost,
        "site_records": [int(p.shape[0]) for p in points],
        "site_rounds": list(rounds),
    }
