"""Readings for ``cost_gap``'s limit where the TF32 control gives none.

At curate-d768 the control (the plain reference with TF32 products) reads
``cost_gap`` no higher than the program does, so the number's upper
reading comes from faults that it, and not ``broken``, sees::

    python3 bench/cost_gap_probe.py calibrate --fault cost_with_outliers \
        --workload curate.fit --seeds 41-43 --out cal_cost_outliers.json
    python3 bench/cost_gap_probe.py explain --workload curate.fit \
        --seeds 12,17

``calibrate`` runs ``bench/calibrate.py`` (its other arguments as they
are) with one of FAULTS planted in the program:

``cost_with_outliers``
    k-means-- returns the weighted cost of every record, the outliers'
    included: the cost summed over the wrong records.
``stale_cost``
    k-means-- skips its final assignment and returns the outliers and cost
    of its last Lloyd step, whose distances were taken at the centers
    before that step moved them: a cost one update stale.

Both leave every guarantee that ``broken`` counts whole.

``explain`` fits the program on each seed's rows (a run's check fits, a
run's sampler seeds) and splits each answer's ``cost_gap`` at its own
centers in float64: ``set_part``, the records that the answer sets aside
and the judge's greedy pass does not, or the other way (their count,
weights and distances beside the greedy pass's last distance set aside);
``sum_part``, the answer's float32 cost against the float64 cost over its
own inliers.  One JSON line a fit.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("cost_with_outliers", "stale_cost")


def _cost_with_outliers(set_attr):
    import torch
    from repro_torch.core import kmeans_mm
    real = kmeans_mm._lloyd_outlier_loop

    def loop(points, w, valid, centers0, **kw):
        res = real(points, w, valid, centers0, **kw)
        return res._replace(cost=torch.sum(
            torch.where(valid, res.distances, 0.0) * w))
    set_attr(kmeans_mm, "_lloyd_outlier_loop", loop)


def _stale_cost(set_attr):
    from repro_torch.core import kmeans_mm
    real = kmeans_mm.lloyd_step
    last = {}

    def lloyd_step(points, w, centers, **kw):
        out = real(points, w, centers, **kw)
        last["dist"], last["amin"] = out[3], out[2]
        return out

    def min_argmin(points, centers, **kw):
        return last["dist"], last["amin"]
    set_attr(kmeans_mm, "lloyd_step", lloyd_step)
    set_attr(kmeans_mm, "min_argmin", min_argmin)


def plant(name: str, set_attr=setattr) -> None:
    """One of FAULTS, by name (``bench/tests/faults.py``'s faults are
    ``bench/calibrate.py``'s own)."""
    if name not in FAULTS:
        raise KeyError(f"{name!r}: this probe plants {FAULTS}")
    (_cost_with_outliers if name == FAULTS[0] else _stale_cost)(set_attr)


def explain(argv) -> int:
    import argparse

    import numpy as np
    import torch
    from bench.calibrate import _seeds
    from bench.harness import program
    from bench.harness.data import make_data
    from bench.harness.spec import load_cell
    from bench.reference.algorithm import greedy_outliers, nearest
    ap = argparse.ArgumentParser(prog="cost_gap_probe.py explain")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cfg, dev = cell.config, torch.device("cuda:0")
    f64 = torch.float64
    for j, seed in enumerate(_seeds(args.seeds)):
        x, _ = make_data(cfg, seed, dev)
        fit = program.make_fit(cfg, x, dev)
        if j == 0:
            fit(program.fit_seed(seed, -1))
        for i in range(int(cell.traffic["check_fits"])):
            ans = program.to_host(fit(program.fit_seed(seed, i)))
            keep = np.asarray(ans["summary_ids"]).reshape(-1) >= 0
            ids = np.asarray(ans["summary_ids"]).reshape(-1)[keep]
            w = torch.as_tensor(np.asarray(ans["summary_weights"]).reshape(
                -1)[keep].astype(np.float64), device=dev)
            out_ids = np.asarray(ans["outlier_ids"]).reshape(-1)
            mine = torch.as_tensor(np.isin(ids, out_ids[out_ids >= 0]),
                                   device=dev)
            c = torch.as_tensor(np.asarray(ans["centers"]), dtype=f64,
                                device=dev)
            dist, _ = nearest(x[torch.as_tensor(ids, device=dev)], c, f64)
            ref = greedy_outliers(dist, w, float(cfg["t"]))
            cost_ref = float((w * dist * ~ref).sum())
            cost_own = float((w * dist * ~mine).sum())
            differ = (ref != mine).nonzero().flatten()
            print(json.dumps({
                "seed": seed, "fit": i,
                "cost_gap": abs(float(ans["cost"]) - cost_ref) / cost_ref,
                "set_part": abs(cost_own - cost_ref) / cost_ref,
                "sum_part": abs(float(ans["cost"]) - cost_own) / cost_ref,
                "records_differ": int(differ.numel()),
                "their_weights": w[differ].tolist()[:8],
                "their_dist": dist[differ].tolist()[:8],
                "answer_sets_aside": mine[differ].tolist()[:8],
                "last_set_aside_dist": float(dist[ref].min()),
            }), flush=True)
        del fit, x
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if argv[:1] == ["explain"]:
        return explain(argv[1:])
    if argv[:1] != ["calibrate"]:
        print(__doc__, file=sys.stderr)
        return 2
    from bench import calibrate
    from bench.tests import faults
    faults.plant = plant       # calibrate.main imports it at its call
    return calibrate.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
