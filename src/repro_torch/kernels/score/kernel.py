"""Wrapper of the CUDA fused score kernel (``csrc/score.cu``, kernel C).

Counterpart of ``repro.kernels.score.kernel.score_pallas``: distance to the
nearest center, its index, and ``dist / max(threshold, 1e-30)`` in one
launch.  The threshold is a one-element float32 tensor on the card, read by
the kernel from device memory (no host synchronisation).  On a CPU tensor
the plain torch version runs.  ``score_cuda.launches`` counts launches.

A call is bound by its launch (``score.cu``), so the wrapper does the least
host work that still checks what the kernel takes: one output buffer of 3n
words whose rows are ``dist``, ``idx`` (an int32 view) and ``score``, fresh
on every call (a caller may still hold the previous batch's results), and
the launch shape from :func:`launch_plan`, cached per (n, d), and the
stream as a raw handle (``_build.stream_ptr``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.kernel import (DTYPE_CODES, METRIC_CODES,
                                              check_operands, padded_width)

SMS = 132     # streaming multiprocessors of an H100


class LaunchPlan(NamedTuple):
    rows: int          # rows of x per CTA (threads per CTA)
    grid: int          # CTAs
    smem_bytes: int    # dynamic shared memory per CTA


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, d: int) -> LaunchPlan:
    """The kernel's launch shape for an (n, d) call.

    Rows per CTA follow n: ``min(NT, max(32, ceil(n / SMS) rounded up to
    32))``, with NT = 256 (128 above d = 128) as ``Tile<DP>::NT``, so a
    256-row micro-batch spreads over 8 SMs and a bulk call keeps NT-row
    CTAs.  Shared memory holds the CTA's rows at a pitch of DP + 4 words,
    then is reused for TM centers and their norms (``score.cu``)."""
    dp = padded_width(d)
    nt = 128 if dp > 128 else 256
    per_sm = -(-n // SMS)
    rows = min(nt, max(32, -(-per_sm // 32) * 32))
    if dp == 0:
        smem = 0
    else:
        tm = 64 if dp <= 64 else (32 if dp <= 128 else 16)
        smem = 4 * max(rows * (dp + 4), tm * (dp + 1))
    return LaunchPlan(rows, -(-n // rows), smem)


def check_threshold(threshold, x: torch.Tensor) -> None:
    """Raise unless ``threshold`` is a one-element float32 tensor on x's
    device (the kernel reads it through a device pointer)."""
    if (not isinstance(threshold, torch.Tensor) or threshold.numel() != 1
            or threshold.dtype != torch.float32
            or threshold.device != x.device):
        raise ValueError(f"score_cuda: threshold must be a one-element "
                         f"float32 tensor on {x.device}")


def _launch(kern, x: torch.Tensor, c: torch.Tensor, threshold, *,
            metric: str = "l2sq"):
    if x.device.type == "cpu":
        from repro_torch.kernels.score.ops import score_blocked
        return score_blocked(x, c, threshold, metric=metric)
    check_operands(x, c, metric, "score_cuda")
    check_threshold(threshold, x)
    n, d = x.shape
    plan = launch_plan(n, d)
    out = torch.empty((3, n), dtype=torch.float32, device=x.device)
    fn = _build.bind("score", "rt_score", 4, 7)
    err = fn(x.data_ptr(), c.data_ptr(), threshold.data_ptr(), out.data_ptr(),
             n, c.shape[0], d, METRIC_CODES[metric], DTYPE_CODES[x.dtype],
             plan.rows, plan.smem_bytes, _build.stream_ptr(x))
    kern.launches += 1
    _build.check(err, "score_cuda")
    dist, idx, score = out.unbind(0)
    return dist, idx.view(torch.int32), score


def _flops(x, c, threshold, **_) -> float:
    """3 a (row, center, feature), as ``min_argmin``'s."""
    return 3.0 * x.shape[0] * c.shape[0] * x.shape[1]


score_cuda = _build.CudaKernel("score", _launch, _flops)
