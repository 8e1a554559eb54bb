"""Wrapper of the CUDA fused score kernel (``csrc/score.cu``, kernel C).

Counterpart of ``repro.kernels.score.kernel.score_pallas``: distance to the
nearest center, its index, and ``dist / max(threshold, 1e-30)`` in one
launch.  The threshold is a 0-d float32 tensor on the card, read by the
kernel from device memory (no host synchronisation).  On a CPU tensor the
plain torch version runs.  ``score_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.kernel import (DTYPE_CODES, METRIC_CODES,
                                              check_operands)


def _launch(kern, x: torch.Tensor, c: torch.Tensor, threshold, *,
            metric: str = "l2sq"):
    if x.device.type == "cpu":
        from repro_torch.kernels.score.ops import score_blocked
        return score_blocked(x, c, threshold, metric=metric)
    check_operands(x, c, metric, "score_cuda")
    if (not isinstance(threshold, torch.Tensor) or threshold.numel() != 1
            or threshold.dtype != torch.float32
            or threshold.device != x.device):
        raise ValueError(f"score_cuda: threshold must be a one-element "
                         f"float32 tensor on {x.device}")
    n, d = x.shape
    thr = threshold.reshape(1).contiguous()
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    score = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _build.bind("score", "rt_score", 6, 5)
    err = fn(x.data_ptr(), c.data_ptr(), thr.data_ptr(), dist.data_ptr(),
             idx.data_ptr(), score.data_ptr(), n, c.shape[0], d,
             METRIC_CODES[metric], DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    kern.launches += 1
    _build.check(err, "score_cuda")
    return dist, idx, score


score_cuda = _build.CudaKernel("score", _launch)
