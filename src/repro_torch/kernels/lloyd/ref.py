"""Plain-torch oracle for the fused Lloyd step.

Port of ``repro.kernels.lloyd.ref``.  Given points x (n,d), weights w (n,),
centers c (k,d), one Lloyd step needs:
  assignment a_i = argmin_j d(x_i, c_j)
  dist_i     = d(x_i, c_{a_i})
  sums_j     = sum_{i: a_i=j} w_i * x_i        (weighted centroid numerators)
  counts_j   = sum_{i: a_i=j} w_i
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pdist.ref import pairwise


def lloyd_step_ref(x, w, c, metric: str = "l2sq"):
    d = pairwise(x, c, metric)
    a = d.argmin(dim=1)
    dist = d.gather(1, a[:, None])[:, 0]
    k = c.shape[0]
    x, w = x.float(), w.float()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, a, x * w[:, None])
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=x.device).index_add_(0, a, w)
    return sums, counts, a.to(torch.int32), dist
