"""Algorithm 3 (Distributed-Median/Means) in the coordinator model.

Port of ``repro.core.distributed``'s host-driven path,
``simulate_coordinator``: each site builds its local summary with
Summary-Outliers(A_i, k, t_i) (Algorithm 1, augmented by Algorithm 2 by
default), the summaries are gathered once, and the second-level weighted
k-means-- runs at the coordinator.  Communication is the number of summary
records gathered.

Partition modes: ``random`` uses the paper's local budget t_i = 2t/s
(Chernoff: all sites respect it w.h.p.); ``adversarial`` uses t_i = t.

Not ported yet (ROADMAP.md): the ``summarizer=`` registry path and the
collective ``distributed_cluster``.
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
    summarizer=None,
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
    rounds per site) and ``phase_s`` (wall seconds of the site summaries
    and of the second level, each ended by a device synchronisation).
    Global ids are offsets into the concatenation of ``parts``.
    """
    if summarizer is not None:
        raise NotImplementedError(
            "summarizer= needs the summarizer registry, which is not ported "
            "yet (ROADMAP.md); leave it None for the paper's Alg. 1/2")
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

    # each site "sends" exactly its live summary records to the coordinator
    pts = torch.cat(all_pts).float()
    wts = torch.cat(all_w).float()
    n_rec = pts.shape[0]
    sol = kmeans_minus_minus(pts, wts,
                             torch.ones((n_rec,), dtype=torch.bool, device=dev),
                             sampler.fold_in(2**31 - 1), k=k, t=float(t),
                             iters=second_iters, metric=metric, policy=policy)
    centers = sol.centers.cpu().numpy()
    out_mask = sol.outlier.cpu().numpy()
    cost = float(sol.cost)
    t2 = time.perf_counter()
    gid = torch.cat(all_gid).cpu().numpy()
    return {
        "centers": centers,
        "outlier_ids": gid[out_mask],
        "summary_ids": gid,
        "summary_weights": wts.cpu().numpy(),
        "summary_candidates": torch.cat(all_cand).cpu().numpy(),
        "comm_records": float(n_rec),
        "cost": cost,
        "site_records": [int(p.shape[0]) for p in all_pts],
        "site_rounds": rounds,
        "phase_s": {"site_summaries": t1 - t0, "second_level": t2 - t1},
    }
