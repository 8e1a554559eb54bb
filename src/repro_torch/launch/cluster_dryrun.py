"""The paper's own job at the production size, port of
``repro.launch.cluster_dryrun``: Algorithm 3 with one site per rank of the
production pod (256 sites; ``--multi``: 512), n = 65,536 points per site,
d = 32, k = 100, t = 131,072, the plain Summary-Outliers at every site
(``summary_alg="plain"``) and ``KernelPolicy(block_n=16384)``, with the
roofline terms of the LM cells.

This is the cell that shows the technique's signature: per-site O(max{k,
log n} n) work against ONE gather of O(k log n + t/s) records, as a
compute-against-collective ratio at the pod's layout.

The reference lowers the sharded program on 512 placeholder devices.  The
port's job draws points on the host and reads data-dependent values
(``kthvalue``, boolean compaction), so fake tensors cannot run it: it runs
for real, all sites host-simulated on one card, as
``core/distributed.py::simulate_coordinator`` runs them with
``summary_alg="plain"``: each site's ``summary_outliers_compact`` with
``sampler.fold_in(i)``, then ``coordinator_fit`` on the union of the
records.  Each site and the second level run under their own
``launch/hlo.py`` counter, so the record's compute and memory terms are
the busiest site's counted flops and bytes plus the second level's (the
sites run side by side on the pod), and its collective term is the ring
model's wire bytes of the one all-gather of the records actually
gathered (each site's payload padded to the largest, as a ring gather
moves it), over the pod's inter-node links.  The terms are reckoned
against one H100's published peaks, not measured; ``wall_s`` is the
measured time of the whole simulation on this one device.

The data is ``data/synthetic.py::gauss``'s distribution (k centers
U(0, 1)^d, sigma 0.1, t outliers shifted by U(-2, 2)^d), drawn on the
device from ``--seed``; rows are assigned to sites at random, the
reference's random partition.

  PYTHONPATH=src python -m repro_torch.launch.cluster_dryrun \\
      [--n-per-site 65536] [--k 100] [--t 131072] [--d 32] [--multi]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.launch.dryrun import (HBM_BW, INTER_NODE_BW, PEAK_FLOPS,
                                       _jsonable)
from repro_torch.launch.hlo import _wire_bytes, analyze_step


def site_data(s: int, n: int, d: int, k: int, t: int, seed: int,
              device) -> tuple:
    """(x (s, n, d) f32, the outliers' global ids) drawn on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = s * n
    centers = torch.rand((k, d), generator=gen, device=dev)
    lab = torch.randint(0, k, (N,), generator=gen, device=dev)
    x = centers[lab] + 0.1 * torch.randn((N, d), generator=gen, device=dev)
    out_ids = torch.randperm(N, generator=gen, device=dev)[:t]
    x[out_ids] += torch.rand((t, d), generator=gen, device=dev) * 4.0 - 2.0
    return x.view(s, n, d), torch.sort(out_ids).values


def run(*, sites: int, n: int, d: int, k: int, t: int, seed: int = 0,
        device="cuda") -> tuple:
    """Run the job; returns (its record, the pieces a caller checks: the
    per-site summaries' rounds and records, the gathered records and the
    result dict)."""
    from repro_torch.core.distributed import coordinator_fit, local_budget
    from repro_torch.core.sampler import TorchSampler
    from repro_torch.core.summary import summary_outliers_compact
    from repro_torch.kernels.dispatch import KernelPolicy

    dev = resolve_device(device)
    x, out_ids = site_data(sites, n, d, k, t, seed, dev)
    sampler = TorchSampler(seed)
    policy = KernelPolicy(block_n=16384)
    t_i = local_budget(t, sites, "random")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pts, wts, gids, cand, rounds, per_site = [], [], [], [], [], []
    for i in range(sites):
        summ, c = analyze_step(summary_outliers_compact, x[i],
                               sampler.fold_in(i), k=k, t=t_i, policy=policy)
        pts.append(summ.points)
        wts.append(summ.weights)
        gids.append(summ.indices.long() + i * n)
        cand.append(summ.is_candidate)
        rounds.append(int(summ.n_rounds))
        per_site.append(c)
    res, c2 = analyze_step(coordinator_fit, pts, wts, gids, cand, rounds,
                           sampler, k=k, t=t, policy=policy)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    busiest = max(per_site, key=lambda a: a["flops"])
    flops = busiest["flops"] + c2["flops"]
    bts = busiest["hbm_bytes"] + c2["hbm_bytes"]
    payload = max(sum(a.numel() * a.element_size() for a in arrs)
                  for arrs in zip(pts, wts, gids, cand))
    wire = _wire_bytes("all-gather", float(payload), sites)
    compute_s, memory_s = flops / PEAK_FLOPS, bts / HBM_BW
    collective_s = wire / INTER_NODE_BW
    rec = {
        "arch": "cluster-job(paper)", "shape": f"s{sites}_n{n}_k{k}_t{t}",
        "mesh": "multi" if sites == 512 else "single",
        "chips": sites, "status": "ok", "compile_s": None,
        "wall_s": wall, "device": str(dev),
        "hlo_flops": flops, "hlo_bytes": bts, "wire_bytes": wire,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max((("compute", compute_s), ("memory", memory_s),
                           ("collective", collective_s)),
                          key=lambda kv: kv[1])[0],
        "collectives": {"all-gather": {"count": 1,
                                       "operand_bytes": payload,
                                       "wire_bytes": wire}},
        "site_flops": {"max": busiest["flops"],
                       "min": min(a["flops"] for a in per_site)},
        "second_level": {"flops": c2["flops"], "hbm_bytes": c2["hbm_bytes"]},
        "site_rounds": {"max": max(rounds), "min": min(rounds)},
        "comm_records": res["comm_records"],
        "comm_fraction": res["comm_records"] / (sites * n),
        "cost": res["cost"],
    }
    return rec, {"x": x, "out_ids": out_ids, "points": pts,
                 "weights": wts, "result": res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-site", type=int, default=65536)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--t", type=int, default=131072)  # ~0.8% of 16.7M points
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--sites", type=int, default=0,
                    help="0: the pod's 256 (--multi: 512)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    s = args.sites or (512 if args.multi else 256)
    rec, _ = run(sites=s, n=args.n_per_site, d=args.d, k=args.k, t=args.t,
                 seed=args.seed, device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"cluster-job__{rec['shape']}__{rec['mesh']}"
    (out / f"{tag}.json").write_text(json.dumps(_jsonable(rec), indent=1))
    print(f"ran {s} sites in {rec['wall_s']:.1f}s on {rec['device']}")
    print(f"compute {rec['compute_s']:.4f}s  memory {rec['memory_s']:.4f}s  "
          f"collective {rec['collective_s']:.6f}s  -> "
          f"{rec['bottleneck']}-bound")
    print({k: (v['count'], round(v['wire_bytes'] / 1e6, 2))
           for k, v in rec["collectives"].items()})
    return rec


if __name__ == "__main__":
    main()
