"""Standalone distributed clustering job, port of
``repro.launch.cluster_job``: the paper's Algorithm 3, one site per rank.

    PYTHONPATH=src python -m repro_torch.launch.cluster_job --sites 8 \\
        --dataset gauss --k 20 --t 400

The reference runs one site per device of a JAX mesh.  Here the job spawns
``--sites`` processes, each a rank of a ``torch.distributed`` group
(``core/collective.py::init_sites``, rendezvous on a free localhost port)
that owns one site: gloo when the ranks share one card (or on the CPU),
NCCL with one rank per card.  Each rank draws the same data from
``--seed``, keeps its part, and runs ``distributed_cluster``; rank 0 prints
the reference's four lines.  ``--sites 0`` takes one site per visible card
(one on the CPU); ``--device cpu`` runs without a card.  A caller with
its own group of ranks runs a rank's part through :func:`site_job`.
"""
from __future__ import annotations

import argparse
import socket
import time

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _devices(n: int, device: str) -> list:
    """Rank r's device: one card per rank where there are enough, else
    every rank on card 0 (gloo), or the CPU."""
    if device == "cpu":
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("cluster_job: --device cuda needs a card")
    ncard = torch.cuda.device_count()
    return [f"cuda:{r}" if n <= ncard else "cuda:0" for r in range(n)]


def _data(args):
    from repro_torch.data.synthetic import gauss, kdd_like, susy_like
    if args.dataset == "gauss":
        return gauss(n_centers=args.k, per_center=args.n // args.k, t=args.t,
                     seed=args.seed)
    if args.dataset == "kdd":
        return kdd_like(n=args.n, seed=args.seed)
    return susy_like(n=args.n, t=args.t, seed=args.seed)


def site_job(rank: int, s: int, args, dev: torch.device):
    """Rank ``rank``'s part of the job in an initialized group of ``s``
    ranks (``core/collective.py::init_sites``), its site on ``dev``:
    returns the reference's four lines on rank 0, None on the others."""
    from repro_torch.core import distributed_cluster
    from repro_torch.core.metrics import clustering_losses, outlier_scores
    from repro_torch.core.sampler import TorchSampler
    from repro_torch.data.synthetic import partition
    from repro_torch.launch.mesh import make_site_mesh

    group = make_site_mesh(s)
    x, out_ids = _data(args)
    parts, gids = partition(x, s, args.partition, seed=args.seed,
                            outlier_ids=out_ids)
    t0 = time.perf_counter()
    res = distributed_cluster(np.stack(parts), TorchSampler(args.seed),
                              group, k=args.k, t=args.t,
                              partition=args.partition, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if rank:
        return None
    conc = np.concatenate(gids)
    oi = res.outlier_ids.cpu().numpy()
    reported = conc[oi[oi >= 0]]
    si = res.summary_ids.cpu().numpy()
    sc = outlier_scores(out_ids, conc[si[si >= 0]], reported)
    mask = np.zeros(x.shape[0], bool)
    mask[reported] = True
    l1, l2 = clustering_losses(
        torch.as_tensor(x, dtype=torch.float32, device=dev),
        res.centers, torch.as_tensor(mask, device=dev))
    comm = float(res.comm_records)
    return [f"sites={s} n={x.shape[0]} partition={args.partition} "
            f"wall={dt:.2f}s (incl. first calls)",
            f"communication: {comm:.0f} records "
            f"({100 * comm / x.shape[0]:.2f}% of data)",
            f"l1={float(l1):.5g} l2={float(l2):.5g}",
            f"preRec={sc.pre_recall:.4f} prec={sc.precision:.4f} "
            f"recall={sc.recall:.4f}"]


def _site(rank: int, args, devices: list, url: str):
    import torch.distributed as dist

    from repro_torch.core.collective import init_sites

    init_sites(rank, devices, init_method=url)
    try:
        lines = site_job(rank, len(devices), args,
                         torch.device(devices[rank]))
        if lines:
            print("\n".join(lines), flush=True)
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="gauss",
                    choices=["gauss", "kdd", "susy"])
    ap.add_argument("--sites", type=int, default=0,
                    help="0 = one site per card")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--t", type=int, default=400)
    ap.add_argument("--n", type=int, default=40_000)
    ap.add_argument("--partition", default="random",
                    choices=["random", "adversarial"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    s = args.sites or (torch.cuda.device_count() if args.device == "cuda"
                       else 1) or 1
    devices = _devices(s, args.device)
    url = f"tcp://localhost:{_free_port()}"
    torch.multiprocessing.start_processes(
        _site, args=(args, devices, url), nprocs=s, start_method="spawn",
        join=True)


if __name__ == "__main__":
    main()
