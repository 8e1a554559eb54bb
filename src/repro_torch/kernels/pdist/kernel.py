"""Wrapper of the CUDA min_argmin kernel (``csrc/pdist.cu``, kernel A).

Counterpart of ``repro.kernels.pdist.kernel.min_argmin_pallas``.  On a
CUDA tensor it launches the kernel on the current stream (or raises); on a
CPU tensor it runs the plain torch version, since there is no kernel to
launch.  ``min_argmin_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2sq": 0, "l2": 1, "l1": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def check_operands(x: torch.Tensor, c: torch.Tensor, metric: str,
                   what: str) -> None:
    """Raise unless (x, c) is a pair the CUDA kernels take as they are."""
    if metric not in METRIC_CODES:
        raise ValueError(f"{what}: metric {metric!r} has no CUDA kernel; "
                         f"expected one of {tuple(METRIC_CODES)}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"{what}: expected x (n, d) and c (m, d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"{what}: x and c must lie on one CUDA device, got "
                         f"{x.device} and {c.device}")
    if x.dtype not in DTYPE_CODES or c.dtype != x.dtype:
        raise TypeError(f"{what}: x and c must share a dtype in "
                        f"(float32, bfloat16), got {x.dtype} and {c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{what}: x and c must be contiguous")
    if c.shape[0] < 1:
        raise ValueError(f"{what}: need at least one center")
    if max(x.numel(), c.numel()) > _INT_MAX:
        raise ValueError(f"{what}: more than 2**31 - 1 elements")


def _launch(kern, x: torch.Tensor, c: torch.Tensor, *, metric: str = "l2sq"):
    if x.device.type == "cpu":
        from repro_torch.kernels.pdist.ops import min_argmin_blocked
        return min_argmin_blocked(x, c, metric=metric)
    check_operands(x, c, metric, "min_argmin_cuda")
    n, d = x.shape
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    fn = _build.bind("pdist", "rt_min_argmin", 4, 5)
    err = fn(x.data_ptr(), c.data_ptr(), dist.data_ptr(), idx.data_ptr(),
             n, c.shape[0], d, METRIC_CODES[metric], DTYPE_CODES[x.dtype],
             _build.stream_ptr(x))
    kern.launches += 1
    _build.check(err, "min_argmin_cuda")
    return dist, idx


min_argmin_cuda = _build.CudaKernel("min_argmin", _launch)
