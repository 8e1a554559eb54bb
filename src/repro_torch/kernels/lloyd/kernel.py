"""Wrapper of the CUDA fused Lloyd step (``csrc/lloyd.cu``, kernel B).

Counterpart of ``repro.kernels.lloyd.kernel.lloyd_step_pallas``: l2sq / l2
assignment plus deterministic weighted accumulation.  On a CUDA tensor it
launches the kernel pair (assign + per-CTA partials, then the in-order
reduce; on the chunked route the centers' norms first) on the current
stream, or raises; on a CPU tensor it runs the plain torch version.
``lloyd_step_cuda.launches`` counts calls that launched the kernels.

A call does the least host work that still checks what the kernels take:
the launch shape from :func:`lloyd_plan`, cached per (n, k, d); one
output buffer cut into the four results (:func:`split_outputs`), fresh on
every call; one scratch buffer for the partials.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.kernel import (CK_SMEM, DTYPE_CODES,
                                              METRIC_CODES, check_operands,
                                              padded_width)

LLOYD_METRICS = ("l2sq", "l2")
# lloyd.cu: LloydRoute.  "centers" and "rows" are the warp route's two ways
# to accumulate: by center (a ballot round per center present among a
# warp's rows) for few centers, by row (each half-warp adds its rows in
# order) above.  On an H100 (chip_smoke.py's Lloyd ladder, PERF.md) by
# center won up to k = 6 at kdd's d = 34 and up to k = 3 at gauss's d = 5;
# FEW_CENTERS = 4 takes each second level's faster way (k = 3 and 100).
ROUTES = ("centers", "rows", "serial", "chunked")
FEW_CENTERS = 4
# Past this width every call takes the chunked route: the assignment by
# pdist.cu's chunked tile (a row a thread in registers does not fit), the
# serial route's accumulation.
CHUNKED_FROM_D = 161
CHUNK_THREADS = 256             # pdist_common.cuh: ChunkTile::NT
# At most this many CTAs: a CTA owns ceil(tiles / MAX_CTAS) whole tiles and
# double-buffers them, and two such CTAs fit on each of an H100's 132 SMs.
# So the kdd and gauss second levels run as one wave (263 and 235 CTAs of 13
# and 3 tiles), and the partials stay at most MAX_CTAS x k (d + 1) words.
# On an H100 264 beat 528, 1,056 and 4,096 at kdd's call by 12-30%, and lost
# to 528 by 10% at gauss's (chip_smoke.py's Lloyd ladder, PERF.md).
MAX_CTAS = 264
SMEM_MAX = 232_448              # bytes of shared memory a CTA may opt in to
SERIAL_ACC_WORDS = 24_576       # lloyd.cu: kSmemAccFloats


class LloydPlan(NamedTuple):
    route: str         # one of ROUTES
    rows: int          # rows of x per CTA: whole tiles of `threads` rows
    grid: int          # CTAs, hence partials per word
    threads: int       # threads per CTA (Tile<DP>::NT), one row each;
                       # the chunked route's 256 take 128 rows at a time
    smem_bytes: int    # dynamic shared memory per CTA


@functools.lru_cache(maxsize=1024)
def lloyd_plan(n: int, k: int, d: int, route=None) -> LloydPlan:
    """The kernels' launch shape for an (n, k, d) call.

    The split of rows over CTAs depends on (n, d) only: tiles of NT = 256
    rows (128 above d = 128), ``ceil(tiles / MAX_CTAS)`` whole tiles per
    CTA.  The warp route takes every padded width whose blocks fit in
    shared memory: two buffers of the CTA's rows at a pitch of DP + 4 words
    and their weights, the k centers and their norms, and the partials:
    one (k, d + 1) block per warp ("centers", for k <= FEW_CENTERS), or
    per half-warp ("rows", above).  Where they do not fit (k (d + 1) too
    large) the serial route, whose per-CTA partial lives in shared memory
    up to SERIAL_ACC_WORDS words and in the scratch beyond.  From
    CHUNKED_FROM_D the chunked route: CTAs of CHUNK_THREADS threads assign
    128 rows at a time (the split's rows are a multiple of it) and keep
    the partial as the serial route does, after the chunked tile's shared
    memory.  A named ``route`` (to measure the routes against each other)
    is taken as it is, or raises where its blocks do not fit."""
    dp = padded_width(d)
    nt = 128 if dp > 128 else 256
    tiles = -(-n // nt)
    rows = nt * max(1, -(-tiles // MAX_CTAS))
    grid = -(-n // rows)
    k1 = k * (d + 1)
    acc = 4 * k1 if k1 <= SERIAL_ACC_WORDS else 0
    if route == "chunked" or (route is None and d >= CHUNKED_FROM_D):
        return LloydPlan("chunked", rows, grid, CHUNK_THREADS, CK_SMEM + acc)
    way = route or ("centers" if k <= FEW_CENTERS else "rows")
    if way != "serial" and dp:
        parts = nt // 32 * (2 if way == "rows" else 1)
        smem = 4 * (2 * nt * (dp + 5) + k * (dp + 1) + parts * k1)
        if smem <= SMEM_MAX:
            return LloydPlan(way, rows, grid, nt, smem)
    if route not in (None, "serial"):
        raise ValueError(f"lloyd_plan: route {route!r} does not fit "
                         f"(n, k, d) = {(n, k, d)}; routes {ROUTES}")
    return LloydPlan("serial", rows, grid, nt, acc)


def split_outputs(buf: torch.Tensor, n: int, k: int, d: int):
    """Views of one float32 buffer of k d + k + 2 n words: sums (k, d),
    counts (k,), the assignment (n,) as int32 and dist (n,)."""
    kd = k * d
    return (buf[:kd].view(k, d), buf[kd:kd + k],
            buf[kd + k:kd + k + n].view(torch.int32), buf[kd + k + n:])


def _launch(kern, x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *,
            metric: str = "l2sq"):
    return _launch_route(None, x, w, c, metric=metric, kern=kern)


def _launch_route(route, x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                  *, metric: str = "l2sq", kern=None):
    """The kernels on ``route``: None for :func:`lloyd_plan`'s choice, one
    of ROUTES, or a whole :class:`LloydPlan` (a measurement of the routes,
    or of other splits of rows, against each other).  ``kern.launches``,
    where ``kern`` is given (:func:`lloyd_step_cuda` gives itself), goes up
    by one where the kernels launch: not for n = 0, whose sums and counts
    are zeros made on the host side.  On a CPU tensor it is the plain
    version."""
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
    buf = torch.empty((k * d + k + 2 * n,), dtype=torch.float32,
                      device=x.device)
    out = split_outputs(buf, n, k, d)
    if n == 0:
        buf.zero_()
        return out
    plan = (route if isinstance(route, LloydPlan)
            else lloyd_plan(n, k, d, route))
    part = torch.empty((plan.grid * k * (d + 1)
                        + (k if plan.route == "chunked" else 0),),
                       dtype=torch.float32, device=x.device)
    sums, counts, assign, dist = out
    fn = _build.bind("lloyd", "rt_lloyd_step", 8, 8)
    err = fn(x.data_ptr(), w.data_ptr(), c.data_ptr(), sums.data_ptr(),
             counts.data_ptr(), assign.data_ptr(), dist.data_ptr(),
             part.data_ptr(), n, k, d, METRIC_CODES[metric],
             DTYPE_CODES[x.dtype], ROUTES.index(plan.route), plan.rows,
             plan.smem_bytes, _build.stream_ptr(x))
    _build.check(err, "lloyd_step_cuda")
    if kern is not None:
        kern.launches += 1
    return out


def _flops(x, w, c, **_) -> float:
    """The assignment's 3 a (row, center, feature), then 2 a (row,
    feature) for the weighted sums."""
    n, d = x.shape
    return 3.0 * n * c.shape[0] * d + 2.0 * n * d


lloyd_step_cuda = _build.CudaKernel("lloyd_step", _launch, _flops)
