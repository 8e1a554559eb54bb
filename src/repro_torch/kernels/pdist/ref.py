"""Plain-torch oracle for the fused min-distance + argmin primitive.

Port of ``repro.kernels.pdist.ref``.  ``min_argmin_ref(x, c, metric)``
computes, for every row of ``x``, the distance to the nearest row of ``c``
and the index of that row (ties -> smallest index).  bf16 inputs are
upcast to f32 first, as the kernels do on load.

Metrics: ``l2sq``, ``l2``, ``l1`` and ``cosine`` (rows normalized
internally; served by the plain backends only, as in the reference).
"""
from __future__ import annotations

import torch

METRICS = ("l2sq", "l2", "l1", "cosine")

# metrics the CUDA pdist kernel implements (see csrc/pdist.cu); keep in sync
CUDA_METRICS = ("l2sq", "l2", "l1")


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def pairwise(x: torch.Tensor, c: torch.Tensor,
             metric: str = "l2sq") -> torch.Tensor:
    """Full (n, m) pairwise distance matrix (oracle, not the production
    path).  l2* use the reference's expansion ``max(x2 + c2 - 2 x.c, 0)``."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    x = x.float()
    c = c.float()
    if metric == "l1":
        return (x[:, None, :] - c[None, :, :]).abs().sum(-1)
    if metric == "cosine":
        sim = _unit(x) @ _unit(c).T
        return torch.clamp(1.0 - sim, 0.0, 2.0)
    x2 = (x * x).sum(-1)
    c2 = (c * c).sum(-1)
    d2 = x2[:, None] + c2[None, :] - 2.0 * (x @ c.T)
    d2 = torch.clamp(d2, min=0.0)
    return d2 if metric == "l2sq" else torch.sqrt(d2)


def min_argmin_ref(x: torch.Tensor, c: torch.Tensor, metric: str = "l2sq"):
    """(min distance, argmin index int32) per row of x. Ties -> smallest
    index (``torch.argmin`` returns the first minimum)."""
    d = pairwise(x, c, metric)
    a = d.argmin(dim=1)
    return d.gather(1, a[:, None])[:, 0], a.to(torch.int32)
