"""Algorithm 3 (Distributed-Median/Means) in the coordinator model.

Port of ``repro.core.distributed``.  Two execution paths, same algorithm:

* ``distributed_cluster`` — the collective path: every site is a rank of a
  ``torch.distributed`` group (``repro_torch.core.collective``).  Each rank
  builds its local summary with Summary-Outliers(A_i, k, t_i) (Algorithm 1,
  augmented by Algorithm 2 by default) on its own block, the fixed-shape
  summaries are exchanged with a single all_gather (THE one round of
  communication the paper allows), and the second-level weighted k-means--
  runs replicated on the union, so every rank returns the same result.

* ``simulate_coordinator`` — the host-driven loop over sites in one
  process: the same summaries' live records, the same second level, and
  communication counted in records.

Partition modes: ``random`` uses the paper's local budget t_i = 2t/s
(Chernoff: all sites respect it w.h.p.); ``adversarial`` uses t_i = t.

``summarizer=`` runs an algorithm of the ``repro_torch.summarize``
registry per site: through its fixed-shape site path in
``distributed_cluster``, through its weighted entry point (unit weights)
in ``simulate_coordinator``.

Both paths report their one round through ``obs.record_comm`` (valid
records and padded bytes per site; ``path="host-sim"`` or
``"shard_map"``), and ``simulate_coordinator`` traces its site summaries
and second level (``oneshot.site_summary``, ``oneshot.second_level``
histograms).  Both open the fit's ``obs`` span tree (the ``obs`` package
docstring): ``oneshot.fit`` (``rank`` on each rank of
``distributed_cluster``), its site summaries, ``distributed_cluster``'s
``oneshot.gather``, and the second level.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.core.augmented import augmented_summary_outliers
from repro_torch.core.collective import gather_sites, replicated_coordinator
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.sampler import Sampler
from repro_torch.core.summary import summary_outliers, summary_outliers_compact
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.summarize.base import (SummarizerPolicy, select_summarizer,
                                        summarize, summarizer_policy)


class DistClusterResult(NamedTuple):
    centers: torch.Tensor        # (k, d)
    outlier_ids: torch.Tensor    # (s*cap,) int32 global ids, flagged first, -1 padded
    summary_ids: torch.Tensor    # (s*cap,) int32 global ids of summary records, -1 padded
    summary_weights: torch.Tensor
    comm_records: torch.Tensor   # () f32 — valid records gathered to the coordinator
    cost: torch.Tensor           # () second-level objective (on the summary)
    # the port's addition: wall seconds of this rank's site summary, the
    # gather and the second level, each ended by a device synchronisation
    phase_s: Optional[dict] = None


def local_budget(t: int, s: int, partition: str) -> int:
    if partition == "adversarial":
        return t
    return max(1, int(math.ceil(2 * t / s)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _site_summarizer(summarizer: SummarizerPolicy | None, summary_alg: str,
                     *, metric: str, k: int, t: int):
    """Resolve the per-site summary algorithm to a fixed-shape callable.

    ``summarizer=None`` maps the legacy ``summary_alg`` string onto the
    registry's ``paper`` entry with the variant pinned, as the reference
    does.
    """
    if summarizer is None:
        if summary_alg not in ("augmented", "plain"):
            raise ValueError(f"unknown summary_alg {summary_alg!r}")
        summarizer = summarizer_policy("paper", variant=summary_alg)
    spec = select_summarizer(summarizer, metric=metric, k=k, t=t)
    if spec.site_summary is None:
        raise ValueError(
            f"summarizer {spec.name!r} has no fixed-shape site path and "
            f"cannot run in distributed_cluster; use simulate_coordinator "
            f"(host-driven) for it")
    params = summarizer.params_dict()

    def summarize_site(x, sampler, *, policy):
        return spec.site_summary(x, sampler, k=k, t=t, alpha=2.0, beta=0.45,
                                 metric=metric, kernel_policy=policy,
                                 **params)

    return summarize_site


def _second_level(points, weights, valid, gids, sampler, *, k, t, iters,
                  metric, policy):
    sol = kmeans_minus_minus(points, weights, valid, sampler, k=k,
                             t=float(t), iters=iters, metric=metric,
                             policy=policy)
    out_ids = torch.where(sol.outlier, gids, -1)
    # flagged first, each group in index order: jnp.argsort is stable,
    # torch.argsort only when asked
    order = torch.argsort((~sol.outlier).to(torch.uint8), stable=True)
    return sol, out_ids[order], order


def _site_block(xp, dev: torch.device) -> torch.Tensor:
    """This rank's ``(n_per, d)`` block of the ``(1, n_per, d)`` slice
    ``xp``, as f32 on ``dev``: a memmapped block is read here, once."""
    if isinstance(xp, torch.Tensor):
        return xp[0].to(dev, torch.float32)
    return torch.from_numpy(np.array(xp[0], np.float32)).to(dev)


def distributed_cluster(
    x_parts,
    sampler: Sampler,
    group=None,
    *,
    k: int,
    t: int,
    partition: str = "random",
    summary_alg: str = "augmented",
    summarizer: SummarizerPolicy | None = None,
    second_iters: int = 25,
    metric: str = "l2sq",
    policy: KernelPolicy | None = None,
    device="cuda",
) -> DistClusterResult:
    """Algorithm 3 as one collective over ``group`` (None: the default
    group, initialized with ``collective.init_sites``), called by every rank
    with the same arguments.

    ``x_parts``: ``(s, n_per, d)`` — a numpy array, a memmap or a tensor —
    with s the group's size; rank r copies only ``x_parts[r]`` to
    ``device``.  Rank r summarizes with ``sampler.fold_in(r)``; its global
    ids are ``indices + r * n_per`` (-1 on padding); one ``gather_sites``
    of (points, weights, valid, gids); the second level draws from
    ``sampler.fold_in(2**31 - 1)``.  The result, on ``device``, is identical
    on every rank.

    ``summarizer`` selects each site's summary algorithm from the
    registry (it must provide a fixed-shape site path); None maps the
    legacy ``summary_alg`` string to the registry's ``paper`` entry.
    """
    dev = resolve_device(device)
    s, n_per, d = x_parts.shape
    t_i = local_budget(t, s, partition)
    summarize_site = _site_summarizer(summarizer, summary_alg,
                                      metric=metric, k=k, t=t_i)

    def per_site(xp, sampler):
        t0 = time.perf_counter()
        site = dist.get_rank(group)
        with obs.span("oneshot.site_summary", site=site):
            summ = summarize_site(_site_block(xp, dev),
                                  sampler.fold_in(site), policy=policy)
            gids = torch.where(summ.valid, summ.indices + site * n_per, -1)
            _sync(dev)
        t1 = time.perf_counter()
        # --- the one round of communication ---
        with obs.span("oneshot.gather"):
            pts, wts, val, gid = gather_sites(
                (summ.points, summ.weights, summ.valid, gids), group)
            _sync(dev)
        t2 = time.perf_counter()
        # --- replicated second level at the "coordinator" ---
        with obs.span("oneshot.second_level"):
            sol, out_ids_sorted, _ = _second_level(
                pts, wts, val, gid, sampler.fold_in(2**31 - 1), k=k, t=t,
                iters=second_iters, metric=metric, policy=policy)
            comm = val.sum().to(torch.float32)
            _sync(dev)
        t3 = time.perf_counter()
        return DistClusterResult(
            centers=sol.centers, outlier_ids=out_ids_sorted,
            summary_ids=gid, summary_weights=wts, comm_records=comm,
            cost=sol.cost,
            phase_s={"site_summary": t1 - t0, "gather": t2 - t1,
                     "second_level": t3 - t2})

    with obs.span("oneshot.fit", root=True, rank=dist.get_rank(group)):
        res = replicated_coordinator(per_site, group, n_sharded=1)(x_parts,
                                                                    sampler)
    # comm accounting happens post-hoc (the gather itself ran inside the
    # collective): valid records per site counted on the card from the id
    # blocks (s ints back), padded bytes from the per-site slice of the
    # gathered payload
    if obs.get_default_registry().enabled:
        gids = res.summary_ids.view(s, -1)
        cap = gids.shape[1]
        per_rec = (gids >= 0).sum(dim=1).tolist()
        site_bytes = cap * (4 * d + 4 + 1 + 4)   # pts + w + valid + gid
        obs.record_comm(per_rec, [site_bytes] * s, path="shard_map")
    return res


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

    with obs.span("oneshot.fit", root=True):
        all_pts, all_w, all_gid, all_cand, rounds = [], [], [], [], []
        t0 = time.perf_counter()
        for i, part in enumerate(parts):
            x = torch.as_tensor(part, dtype=torch.float32, device=dev)
            skey = sampler.fold_in(i)
            with obs.trace("oneshot.site_summary", site=i):
                if summarizer is not None:
                    ws = summarize(x, torch.ones((x.shape[0],), device=dev),
                                   skey, k=k, t=t_i, metric=metric,
                                   policy=summarizer, kernel_policy=policy)
                    all_pts.append(ws.points)
                    all_w.append(ws.weights)
                    all_gid.append(ws.indices + int(offs[i]))
                    all_cand.append(ws.is_candidate)
                    rounds.append(ws.n_rounds)
                    continue
                if summary_alg == "augmented":
                    summ = augmented_summary_outliers(
                        x, skey, k=k, t=t_i, metric=metric, policy=policy)
                elif compact:
                    summ = summary_outliers_compact(
                        x, skey, k=k, t=t_i, metric=metric, policy=policy)
                else:
                    summ = summary_outliers(x, skey, k=k, t=t_i,
                                            metric=metric, policy=policy)
                valid = summ.valid
                all_pts.append(summ.points[valid])
                all_w.append(summ.weights[valid])
                all_gid.append(summ.indices[valid].long() + int(offs[i]))
                all_cand.append(summ.is_candidate[valid])
                rounds.append(int(summ.n_rounds))
        _sync(dev)
        t1 = time.perf_counter()
        # each site "sends" exactly its live summary records to the
        # coordinator
        obs.record_comm(
            [p.shape[0] for p in all_pts],
            [sum(a.numel() * a.element_size() for a in arrs)
             for arrs in zip(all_pts, all_w, all_gid, all_cand)],
            path="host-sim")
        with obs.trace("oneshot.second_level"):
            res = coordinator_fit(all_pts, all_w, all_gid, all_cand,
                                  rounds, sampler, k=k, t=t,
                                  second_iters=second_iters, metric=metric,
                                  policy=policy)
        t2 = time.perf_counter()
        res["phase_s"] = {"site_summaries": t1 - t0,
                          "second_level": t2 - t1}
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
