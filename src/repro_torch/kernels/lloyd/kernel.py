"""Wrapper of the CUDA fused Lloyd step (``csrc/lloyd.cu``, kernel B).

Counterpart of ``repro.kernels.lloyd.kernel.lloyd_step_pallas``: l2sq / l2
assignment plus deterministic weighted accumulation.  On a CUDA tensor it
launches the kernel pair (assign + per-CTA partials, then the in-order
reduce) on the current stream, or raises; on a CPU tensor it runs the
plain torch version.  ``lloyd_step_cuda.launches`` counts calls that
launched the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.kernel import (DTYPE_CODES, METRIC_CODES,
                                              check_operands)

LLOYD_METRICS = ("l2sq", "l2")


def _launch(kern, x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *,
            metric: str = "l2sq"):
    if x.device.type == "cpu":
        from repro_torch.kernels.dispatch import KernelPolicy
        from repro_torch.kernels.lloyd.ops import lloyd_step_blocked
        return lloyd_step_blocked(x, w, c, metric=metric,
                                  policy=KernelPolicy(backend="blocked"))
    if metric not in LLOYD_METRICS:
        raise ValueError(f"lloyd_step_cuda: metric {metric!r} has no CUDA "
                         f"Lloyd kernel; expected one of {LLOYD_METRICS}")
    check_operands(x, c, metric, "lloyd_step_cuda")
    n, d = x.shape
    k = c.shape[0]
    if (w.shape != (n,) or w.dtype != torch.float32 or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"lloyd_step_cuda: w must be a contiguous float32 "
                         f"({n},) tensor on {x.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if k * (d + 1) > 2**31 - 1:
        raise ValueError("lloyd_step_cuda: k * (d + 1) exceeds 2**31 - 1")
    dev = x.device
    blocks = _build.bind("lloyd", "rt_lloyd_blocks", 0, 2, stream=False)
    g = blocks(n, d) if n > 0 else 0
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    part = torch.empty((max(g, 1), k * (d + 1)), dtype=torch.float32,
                       device=dev)
    if n == 0:
        return sums.zero_(), counts.zero_(), assign, dist
    fn = _build.bind("lloyd", "rt_lloyd_step", 8, 6)
    err = fn(x.data_ptr(), w.data_ptr(), c.data_ptr(), sums.data_ptr(),
             counts.data_ptr(), assign.data_ptr(), dist.data_ptr(),
             part.data_ptr(), n, k, d, g, METRIC_CODES[metric],
             DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    kern.launches += 1
    _build.check(err, "lloyd_step_cuda")
    return sums, counts, assign, dist


lloyd_step_cuda = _build.CudaKernel("lloyd_step", _launch)
