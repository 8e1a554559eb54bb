"""The comparison that decides ``correct``.

A fit's answer is judged against the configuration's data, in float64, by
the plain arithmetic of ``algorithm.py``; the judge takes from the answer
only what it judges (record ids, weights and candidate flags per site,
centers, outlier ids, cost) and works the rest out again from the rows
the benchmark made.  The draws of a fit are its own: the judge does not
replay them.  It checks what must hold whatever was drawn.

Per fit, four numbers:

``broken``
    Guarantees of the configuration that the answer breaks, counted:
    the records it says it sent are its valid ids; ids are distinct and
    lie in their site; weights are whole and >= 1 and add up to each
    site's rows; where the answer flags candidates, a candidate weighs 1,
    a site has at most 8 t_i of them and at least ``CENTER_SHARE`` as many
    centers (Algorithm 2 draws as many centers as it has candidates); the
    outliers are distinct records whose weights add up to at most t;
    centers and cost are finite.  Limit 0.
``moved_share``
    Site summaries (Algorithm 2, line 3).  Every row of a site that is
    not itself a record counts toward its nearest center; the centers
    that drew rows are the site's records of weight >= 2 (a record of
    weight 1 drew none, so a sound answer never has a row nearer to it
    than to its own center).  The judge assigns each such row to its
    nearest record of weight >= 2 and counts the weights again; the
    number is the share of the rows whose weight sits elsewhere:
    sum |w - w_ref| / 2 / n.
``cost_gap``
    Second level, at the answer's centers: the reference sets aside the
    records whose weights add up to at most t, the farthest first, and
    weighs the distance of the rest to their nearest center:
    |cost - cost_ref| / cost_ref.  An answer that sets aside other
    records, or assigns or weighs them otherwise, reads far off.
``center_step``
    One more weighted Lloyd step from the answer's centers over the
    reference's inliers: the largest center move, over the inliers' RMS
    distance to their center.  25 steps of a sound k-means-- leave it
    small; centers that never left their seeds move far.

The numbers of a run are the largest over the fits it checks.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from bench.reference.algorithm import (greedy_outliers, nearest,
                                       site_budget, site_sizes)

NUMBERS = ("broken", "moved_share", "cost_gap", "center_step")
LIMITS = Path(__file__).resolve().parent / "limits"
# Least share of a site's candidates that its centers make up.  Drawn with
# replacement, |X_r| - |S| draws from the ~n_i - 2|X_r| free rows repeat a
# share of about |X_r| / (2 (n_i - 2 |X_r|)): 5% at kddFull's sites (22.4k
# candidates of 245k rows), under 1% at SUSY's.
CENTER_SHARE = 0.9
F64 = torch.float64


def load_limits(config_name: str) -> dict:
    """The limits of configuration ``config_name``:
    ``bench/reference/limits/<config_name>.json``, a file of its own, so a
    new configuration adds its limits and edits none."""
    path = LIMITS / f"{config_name}.json"
    if not path.exists():
        raise KeyError(f"no limits for {config_name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def _valid(a) -> np.ndarray:
    a = np.asarray(a).reshape(-1)
    return a[a >= 0]


def _broken(ans: dict, cfg: dict, n: int) -> tuple[int, np.ndarray]:
    """(count of broken guarantees, the answer's valid ids)."""
    s, k, t = int(cfg["sites"]), int(cfg["k"]), float(cfg["t"])
    ids_all = np.asarray(ans["summary_ids"]).reshape(-1).astype(np.int64)
    keep = ids_all >= 0
    ids = ids_all[keep]
    w = np.asarray(ans["summary_weights"]).reshape(-1)[keep].astype(
        np.float64)
    bad = int(float(ans["comm_records"]) != ids.size)
    bad += ids.size - np.unique(ids).size
    bad += int(((ids < 0) | (ids >= n)).sum())
    bad += int(((w < 1) | (w != np.round(w))).sum())
    edges = np.concatenate([[0], np.cumsum(site_sizes(n, s))])
    site = np.searchsorted(edges, ids, side="right") - 1
    mass = np.bincount(site, weights=w, minlength=s)[:s]
    bad += int((mass != np.diff(edges)).sum())
    cand = ans.get("summary_candidates")
    if cand is not None:
        cand = np.asarray(cand).reshape(-1)[keep].astype(bool)
        bad += int((w[cand] != 1).sum())
        per_site = np.bincount(site[cand], minlength=s)[:s]
        bad += int((per_site > 8 * site_budget(int(t), s)).sum())
        # Algorithm 2 draws |X_r| - |S| more centers: a site's centers
        # number its candidates less the draws' repeats
        centers = np.bincount(site[~cand], minlength=s)[:s]
        bad += int((centers < CENTER_SHARE * per_site).sum())
    out = _valid(ans["outlier_ids"]).astype(np.int64)
    bad += out.size - np.unique(out).size
    order = np.argsort(ids)
    at = order[np.clip(np.searchsorted(ids, out, sorter=order), 0,
                       max(ids.size - 1, 0))] if ids.size else out[:0]
    found = ids[at] == out if ids.size else np.zeros(out.size, bool)
    bad += int((~found).sum())
    bad += int(w[at[found]].sum() > t)
    centers = np.asarray(ans["centers"])
    bad += int(centers.shape != (k, int(cfg["d"]))
               or not np.isfinite(centers).all())
    bad += int(not np.isfinite(float(ans["cost"])))
    return bad, ids


def _moved_share(x: torch.Tensor, ids: np.ndarray, w: np.ndarray,
                 cfg: dict) -> float:
    n = x.shape[0]
    dev = x.device
    edges = np.concatenate([[0], np.cumsum(site_sizes(n, int(cfg["sites"])))])
    moved = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (ids >= lo) & (ids < hi)
        rec, rw = ids[sel] - lo, w[sel]
        is_rec = torch.zeros((hi - lo,), dtype=torch.bool, device=dev)
        is_rec[torch.as_tensor(rec, device=dev)] = True
        rows = x[lo:hi][~is_rec]
        drew = rw >= 2
        ref = np.ones_like(rw)
        if drew.any():
            _, near = nearest(rows, x[lo:hi][torch.as_tensor(
                rec[drew], device=dev)], F64)
            ref[drew] += np.bincount(near.cpu().numpy(),
                                     minlength=int(drew.sum()))
        else:
            moved += 2.0 * rows.shape[0]      # rows with no center at all
        moved += np.abs(rw - ref).sum()
    return moved / 2.0 / n


def _second_level(x: torch.Tensor, ids: np.ndarray, w: np.ndarray,
                  ans: dict, cfg: dict) -> dict:
    dev = x.device
    k, t = int(cfg["k"]), float(cfg["t"])
    pts = x[torch.as_tensor(ids, device=dev)].to(F64)
    wt = torch.as_tensor(w, dtype=F64, device=dev)
    c = torch.as_tensor(np.asarray(ans["centers"]), dtype=F64, device=dev)
    dist, near = nearest(pts, c, F64)
    out = greedy_outliers(dist, wt, t)
    inl = wt * ~out
    cost = float((inl * dist).sum())
    onehot = (near[:, None] == torch.arange(k, device=dev)).to(F64) \
        * inl[:, None]
    mass = onehot.sum(0)
    step = torch.where(mass[:, None] > 0,
                       (onehot.T @ pts) / mass.clamp(min=1e-300)[:, None] - c,
                       torch.zeros_like(c))
    radius = (cost / max(float(inl.sum()), 1e-300)) ** 0.5
    return {
        "cost_gap": abs(float(ans["cost"]) - cost) / max(cost, 1e-300),
        "center_step": float(step.norm(dim=1).max()) / max(radius, 1e-300),
    }


def judge_fit(x: torch.Tensor, ans: dict, cfg: dict) -> dict:
    """The numbers of one fit's answer (see the module docstring)."""
    n = x.shape[0]
    broken, ids = _broken(ans, cfg, n)
    keep = np.asarray(ans["summary_ids"]).reshape(-1) >= 0
    w = np.asarray(ans["summary_weights"]).reshape(-1)[keep].astype(
        np.float64)
    nums = {"broken": float(broken)}
    if broken:      # ids or weights that do not describe the rows: the
        return nums  # other numbers have nothing sound to compare
    nums["moved_share"] = _moved_share(x, ids, w, cfg)
    nums.update(_second_level(x, ids, w, ans, cfg))
    return nums


def judge(x: torch.Tensor, answers: list, cfg: dict, limits: dict):
    """(correct, numbers, wrong): each number the largest over the answers
    (None where an answer broke a guarantee and left it unread); correct
    when each is read and within its limit; wrong the count of answers
    that are not."""
    worst = {k: 0.0 for k in NUMBERS}
    wrong = 0
    for ans in answers:
        nums = judge_fit(x, ans, cfg)
        wrong += not all(nums.get(k) is not None and nums[k] <= limits[k]
                         for k in NUMBERS)
        for key in NUMBERS:
            v = nums.get(key)
            worst[key] = None if v is None or worst[key] is None \
                else max(worst[key], v)
    return bool(answers) and not wrong, worst, wrong


def quality(answers: list, truth: torch.Tensor) -> dict:
    """The paper's outlier quality of the answers, against the planted
    outliers (reported, not compared): preRec = planted outliers among the
    summary records, precision and recall of the returned outliers."""
    tr = truth.cpu().numpy()
    n_true = max(1, int(tr.sum()))
    pre, prec, rec = [], [], []
    for ans in answers:
        ids, out = _valid(ans["summary_ids"]), _valid(ans["outlier_ids"])
        pre.append(float(tr[ids].sum()) / n_true)
        hit = float(tr[out].sum())
        prec.append(hit / max(1, out.size))
        rec.append(hit / n_true)
    if not answers:
        return {}
    return {"preRec": min(pre), "precision": min(prec), "recall": min(rec)}
