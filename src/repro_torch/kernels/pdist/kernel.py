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
ROUTES = ("rowscan", "tiled")
# pdist_common.cuh: dispatch_dp's padded widths (0: the generic path, d > 256)
PADDED_WIDTHS = (8, 16, 24, 32, 40, 48, 64, 96, 128, 160, 256)
# The least m of the tiled route, as (least d, least m) bands, for d up to
# TILED_MAX_D (its shared-memory tiles hold d padded to a multiple of 4).
# On an H100 (chip_smoke.py's route ladder, PERF.md) the routes cross
# between m = 48 and 64 at d = 34 and between 200 and 256 at d = 16
# (n = 244,922), and between 512 and 1,536 at d = 5 (n = 50,000; where
# in that span depends on the host's cost of a small call): below that, the
# tiled route's fixed cost (a second launch for the center norms) outweighs
# its cheaper pairs, and the fewer the coordinates, the less a pair saves.
# Each band takes the threshold of its smallest measured d.
TILED_MIN_M = ((34, 64), (16, 256), (1, 1536))
TILED_MAX_D = 64


def padded_width(d: int) -> int:
    """The kernels' compile-time width DP for d (0: generic, d > 256)."""
    return next((w for w in PADDED_WIDTHS if d <= w), 0)


def tiled_min_m(d: int):
    """The least m of the tiled route at width d; None where it takes no
    such d."""
    if not 1 <= d <= TILED_MAX_D:
        return None
    return next(m for least_d, m in TILED_MIN_M if d >= least_d)


def route(n: int, m: int, d: int, metric: str = "l2sq"):
    """The CUDA route for an (n, m, d) call: ``"tiled"`` for m >=
    :func:`tiled_min_m` (d), else ``"rowscan"``; None for a metric with no
    CUDA kernel (cosine stays on the plain path)."""
    if metric not in METRIC_CODES:
        return None
    least = tiled_min_m(d)
    if n > 0 and least is not None and m >= least:
        return "tiled"
    return "rowscan"


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
    out = _launch_route(None, x, c, metric=metric)
    if x.device.type == "cuda":
        kern.launches += 1
    return out


def _launch_route(how, x: torch.Tensor, c: torch.Tensor, *,
                  metric: str = "l2sq"):
    """The kernel of route ``how`` (``"rowscan"`` or ``"tiled"``; None for
    :func:`route`'s choice), with no launch counted: :func:`min_argmin_cuda`
    calls it with None, and a measurement of the routes against each other
    names the route.  On a CPU tensor it is the plain version."""
    if x.device.type == "cpu":
        from repro_torch.kernels.pdist.ops import min_argmin_blocked
        return min_argmin_blocked(x, c, metric=metric)
    check_operands(x, c, metric, "min_argmin_cuda")
    n, d = x.shape
    m = c.shape[0]
    how = how or route(n, m, d, metric)
    if how not in ROUTES or (how == "tiled" and d > TILED_MAX_D):
        raise ValueError(f"min_argmin_cuda: route {how!r} does not take "
                         f"d = {d}; routes {ROUTES}, tiled for d <= "
                         f"{TILED_MAX_D}")
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    codes = (n, m, d, METRIC_CODES[metric], DTYPE_CODES[x.dtype],
             _build.stream_ptr(x))
    if how == "tiled":
        c2 = torch.empty((m,), dtype=torch.float32, device=x.device)
        fn = _build.bind("pdist", "rt_min_argmin_tiled", 5, 5)
        err = fn(x.data_ptr(), c.data_ptr(), c2.data_ptr(), dist.data_ptr(),
                 idx.data_ptr(), *codes)
    else:
        fn = _build.bind("pdist", "rt_min_argmin", 4, 5)
        err = fn(x.data_ptr(), c.data_ptr(), dist.data_ptr(),
                 idx.data_ptr(), *codes)
    _build.check(err, "min_argmin_cuda")
    return dist, idx


def _flops(x, c, **_) -> float:
    """3 a (row, center, feature): difference, product, sum."""
    return 3.0 * x.shape[0] * c.shape[0] * x.shape[1]


min_argmin_cuda = _build.CudaKernel("min_argmin", _launch, _flops)
