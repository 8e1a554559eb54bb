"""Evaluation metrics from the paper's Section 5.1.2.

Port of ``repro.core.metrics``.  Clustering quality:  l1-loss (k,t)-median
and l2-loss (k,t)-means over the ORIGINAL dataset X given returned centers C
and outliers O.  Outlier detection, against ground truth O*:
  preRec = |S  cap O*| / |O*|   (S = summary fed to the 2nd level)
  recall = |O  cap O*| / |O*|
  prec   = |O  cap O*| / |O|
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.pdist.ops import min_argmin


class OutlierScores(NamedTuple):
    pre_recall: float
    precision: float
    recall: float


def clustering_losses(x, centers, outlier_mask_x, *,
                      policy: Optional[KernelPolicy] = None):
    """(l1, l2) losses of centers over X \\ O.  outlier_mask_x is (n,) bool."""
    d1, _ = min_argmin(x, centers, metric="l2", policy=policy)
    keep = ~outlier_mask_x
    l1 = torch.where(keep, d1, 0.0).sum()
    l2 = torch.where(keep, d1 * d1, 0.0).sum()
    return l1, l2


def outlier_scores(true_idx, summary_idx, reported_idx) -> OutlierScores:
    """All args are integer index arrays into X (tensors or numpy)."""
    def as_set(a):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return set(np.asarray(a).tolist())

    true_set = as_set(true_idx)
    s_set = as_set(summary_idx)
    o_set = as_set(reported_idx)
    pre = len(s_set & true_set) / max(len(true_set), 1)
    rec = len(o_set & true_set) / max(len(true_set), 1)
    prc = len(o_set & true_set) / max(len(o_set), 1)
    return OutlierScores(pre_recall=pre, precision=prc, recall=rec)
