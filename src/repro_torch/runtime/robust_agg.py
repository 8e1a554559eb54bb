"""Byzantine-robust gradient aggregation via the paper's outlier detection,
port of ``repro.runtime.robust_agg`` on ``torch.distributed``.

Each data-parallel replica (a rank) sketches its gradient (fixed-seed
Rademacher projection of every leaf into R^PROJ, summed and normalized) —
the sketches of honest replicas concentrate, corrupted ones are outliers.
This is exactly (k=1, t)-means over s points in R^PROJ, so the paper's
machinery is reused: all replicas see all sketches after one all_gather
(the paper's one-round coordinator model again), each replica
deterministically runs k-means-- (k=1) on them — through the kernel
registry, so on the card ``lloyd_step`` and ``min_argmin`` — masks the
flagged replicas, and sums only the honest gradients (rescaled).

The reference runs inside ``shard_map`` over a data axis; here the group's
ranks take its place (``group=None``: the default group), the rank's index
replaces ``jax.lax.axis_index``, and ``core.collective``'s ``gather_sites``
and ``sum_sites`` the all_gather and the psum.  Every random draw goes
through a :class:`Sampler` made from the seed (``sampler_from_seed``,
:class:`TorchSampler` by default), the same on every rank, so no extra
coordination round is needed.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import flatten
from repro_torch.core.collective import _tree_map, gather_sites, sum_sites
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.sampler import Sampler, TorchSampler

PROJ = 64


def rademacher(sampler: Sampler, shape, device=None) -> torch.Tensor:
    """+-1 f32 signs: ``jax.random.rademacher``'s ``2 * (uniform < 0.5) -
    1``, drawn through the sampler's ``uniform``."""
    u = sampler.uniform(shape, 0.0, 1.0, device=device)
    return 2.0 * (u < 0.5).float() - 1.0


def _leaf_sketch(g: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    flat = g.reshape(-1).float()
    # fixed Rademacher projection of the leaf's first <= 4096 entries
    sign = rademacher(sampler, (PROJ, min(flat.shape[0], 4096)), g.device)
    return sign @ flat[:sign.shape[1]]


def sketch(grads, seed: int = 0, *,
           sampler_from_seed: Callable[[int], Sampler] = TorchSampler) \
        -> torch.Tensor:
    """(PROJ,) sketch of a gradient tree. Same seed on every replica."""
    leaves = flatten(grads)          # jax.tree_util's order: dict keys sorted
    samplers = sampler_from_seed(seed).split(len(leaves))
    s = sum(_leaf_sketch(g, smp) for g, smp in zip(leaves, samplers))
    return s / torch.clamp(torch.linalg.vector_norm(s), min=1e-9)


def robust_mean_grads(grads, group=None, *, byzantine_budget: int = 1,
                      seed: int = 0,
                      sampler_from_seed: Callable[[int], Sampler]
                      = TorchSampler):
    """On every rank of ``group``: returns (robust mean grads, mask_info).

    mask_info = (honest_count, my_outlier_flag), 0-dim tensors.  The mean
    is f32, identical on every rank."""
    s = sketch(grads, seed, sampler_from_seed=sampler_from_seed)
    all_s = gather_sites(s[None], group)            # (n_replicas, PROJ)
    n = all_s.shape[0]
    sol = kmeans_minus_minus(
        all_s, torch.ones((n,), dtype=torch.float32, device=s.device),
        torch.ones((n,), dtype=torch.bool, device=s.device),
        sampler_from_seed(seed + 1), k=1, t=float(byzantine_budget),
        iters=8)
    # significance gate: k-means-- always labels the farthest budget-mass as
    # outliers; only reject replicas well outside the honest concentration.
    d = sol.distances
    inl = ~sol.outlier
    nh0 = torch.clamp(inl.sum(), min=1)
    mu = torch.where(inl, d, 0.0).sum() / nh0
    sd = torch.sqrt(torch.where(inl, (d - mu) ** 2, 0.0).sum() / nh0)
    gate = mu + 4.0 * sd + 1e-6
    honest = ~(sol.outlier & (d > gate))            # (n,) same on all ranks
    my_ok = honest[dist.get_rank(group)]
    n_honest = torch.clamp(honest.sum(), min=1)
    masked = _tree_map(lambda g: torch.where(my_ok, g.float(), 0.0), grads)
    total = sum_sites(masked, group)
    mean = _tree_map(lambda g: g / n_honest.float(), total)
    return mean, (n_honest, ~my_ok)
