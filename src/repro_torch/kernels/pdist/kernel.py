"""Wrapper of the CUDA min_argmin kernel (``csrc/pdist.cu``, kernel A).

Counterpart of ``repro.kernels.pdist.kernel.min_argmin_pallas``.  On a
CUDA tensor it launches the kernel on the current stream (or raises); on a
CPU tensor it runs the plain torch version, since there is no kernel to
launch.  ``min_argmin_cuda.launches`` counts wrapper calls on CUDA.

Most calls on the main path are small (Alg. 1's rounds, the stream's
merges: a few to a few tens of device us), so a call does the least host
work that still checks what the kernel takes, as ``score``'s and
``lloyd_step``'s do: the operands checked once each, the launch shape
from :func:`launch_plan` and its C arguments from :func:`_rowscan_args`,
both cached per call shape, one output buffer whose rows are ``dist`` and
``idx`` (an int32 view), fresh on every call (a caller may keep the
previous results), and the stream as a raw handle (``_build.stream_ptr``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2sq": 0, "l2": 1, "l1": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
ROUTES = ("rowscan", "tiled", "chunked")
# pdist_common.cuh: dispatch_dp's padded widths (0: the generic path, d > 256)
PADDED_WIDTHS = (8, 16, 24, 32, 40, 48, 64, 96, 128, 160, 256)
# The least m of the tiled route, as (least d, least m) bands, for d up to
# TILED_MAX_D (its shared-memory tiles hold d padded to a multiple of 4).
# On an H100 (chip_smoke.py's route ladder, device us per call from a CUDA
# graph, PERF.md) the small-m route, which scans with two rows a thread and
# every center staged once, beat the tiled route up to m = 160 and lost from
# 192 at d = 34 and at d = 64 (n = 244,922), up to 224 and from 256 at
# d = 16, and up to 384 and from 512 at d = 5 (n = 50,000): below, the
# tiled route's fixed cost (a second launch for the center norms, whole
# 64-center tiles) outweighs its cheaper pairs.  Each band takes its
# smallest measured d's crossing, by linear interpolation between those two
# rungs (m = 169, 233 and 399), rounded up to a multiple of 8.
TILED_MIN_M = ((34, 176), (16, 240), (1, 400))
TILED_MAX_D = 64
# pdist.cu's tiled route: rows per CTA and centers per tile
TL_BM, TL_BN = 128, 64
# The chunked route (pdist.cu: rt_min_argmin_chunked, the tiled route's
# SIMT tile with d streamed in chunks) takes every call past CHUNKED_ALL_D,
# whatever m: the small-m route's generic width reads each row from global
# memory again for every center.  Between TILED_MAX_D and CHUNKED_ALL_D
# its least m, as (least d, least m) bands.  On an H100 (chip_smoke.py's
# wide route ladder, n = 62,500 unit rows, device us per call from a CUDA
# graph, PERF.md) the small-m route won up to m = 64 and lost from 96 at
# d = 65 (35.9 / 43.9 us, 51.3 / 44.7), up to 48 and from 64 at d = 96,
# up to 32 and from 48 at d = 128, up to 64 and from 96 at d = 160 (and
# again at m = 160, by 10%: 160 centers fill two 128-center tiles), up to
# 8 and from 16 at d = 200 and up to 16 and from 32 at d = 256; at
# m = 256 it took 1.6-4.6 ms past d = 160 (its widest padded width, 256,
# holds one row a thread in 256 registers) against the chunked route's
# 0.08-0.30 ms.  Each band takes the crossing of the d it starts at, by
# linear interpolation between the two rungs, rounded up to a multiple of
# 8; the last band, the larger of its two ends' (d = 256: 19, so 24).
CHUNKED_MIN_M = ((200, 24), (160, 88), (128, 48), (96, 56), (65, 88))
CHUNKED_ALL_D = 256
# pdist_common.cuh: ChunkTile's rows per CTA, centers per tile and dynamic
# shared memory
CK_BM, CK_BN, CK_SMEM = 128, 128, 68_096

SMS = 132                     # streaming multiprocessors of an H100
SMEM_MAX = 232_448            # dynamic shared memory a CTA may opt in to
SMEM_PER_SM = 233_472         # shared memory an SM splits among its CTAs
MAX_THREADS_PER_SM = 2_048
MAX_CTAS_PER_SM = 32
ROW_BUFS_MAX = 98_304         # the small-m route's row buffers, bytes
# At most this many centers, a tile's scan is too short to hide the next
# tile's copy: two row buffers, else one (more CTAs an SM).
FEW_CENTERS = 8
BALANCE = 1.04                # rows per tile: busiest SM within 4% of best


def padded_width(d: int) -> int:
    """The kernels' compile-time width DP for d (0: generic, d > 256)."""
    return next((w for w in PADDED_WIDTHS if d <= w), 0)


def tiled_min_m(d: int):
    """The least m of the tiled route at width d; None where it takes no
    such d."""
    if not 1 <= d <= TILED_MAX_D:
        return None
    return next(m for least_d, m in TILED_MIN_M if d >= least_d)


def chunked_min_m(d: int):
    """The least m of the chunked route at width d (1 past
    CHUNKED_ALL_D); None where the tiled route takes d."""
    if d <= TILED_MAX_D:
        return None
    if d > CHUNKED_ALL_D:
        return 1
    return next(m for least_d, m in CHUNKED_MIN_M if d >= least_d)


def route(n: int, m: int, d: int, metric: str = "l2sq"):
    """The CUDA route for an (n, m, d) call: ``"tiled"`` for m >=
    :func:`tiled_min_m` (d), ``"chunked"`` for m >= :func:`chunked_min_m`
    (d), else ``"rowscan"``; None for a metric with no CUDA kernel (cosine
    stays on the plain path)."""
    if metric not in METRIC_CODES:
        return None
    if n > 0 and d >= 1:
        least = tiled_min_m(d) or chunked_min_m(d)
        if m >= least:
            return "tiled" if d <= TILED_MAX_D else "chunked"
    return "rowscan"


def check_operands(x: torch.Tensor, c: torch.Tensor, metric: str,
                   what: str) -> None:
    """Raise unless (x, c) is a pair the CUDA kernels take as they are (each
    attribute read once: this runs on every call)."""
    if metric not in METRIC_CODES:
        raise ValueError(f"{what}: metric {metric!r} has no CUDA kernel; "
                         f"expected one of {tuple(METRIC_CODES)}")
    xs, cs = x.shape, c.shape
    if len(xs) != 2 or len(cs) != 2 or xs[1] != cs[1]:
        raise ValueError(f"{what}: expected x (n, d) and c (m, d), got "
                         f"{tuple(xs)} and {tuple(cs)}")
    dev = x.device
    if dev.type != "cuda" or c.device != dev:
        raise ValueError(f"{what}: x and c must lie on one CUDA device, got "
                         f"{dev} and {c.device}")
    dt = x.dtype
    if dt not in DTYPE_CODES or c.dtype != dt:
        raise TypeError(f"{what}: x and c must share a dtype in "
                        f"(float32, bfloat16), got {dt} and {c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{what}: x and c must be contiguous")
    if cs[0] < 1:
        raise ValueError(f"{what}: need at least one center")
    if max(xs[0] * xs[1], cs[0] * cs[1]) > _INT_MAX:
        raise ValueError(f"{what}: more than 2**31 - 1 elements")


class LaunchPlan(NamedTuple):
    route: str         # one of ROUTES
    rows: int          # rows of x per tile (rowscan: R a thread)
    grid: int          # CTAs (rowscan: each walks tiles blockIdx.x, + grid)
    smem_bytes: int    # dynamic shared memory per CTA (rowscan)
    centers: int       # centers staged at once (rowscan: m when all fit)
    buffers: int       # row buffers a CTA cycles through (rowscan: 1, 2)


def rows_per_thread(dp: int) -> int:
    """pdist.cu: RowsPerThread, the small-m route's rows a thread at padded
    width DP (each center word it reads feeds that many rows' FMAs)."""
    return 2 if dp <= 64 else 1


# The small-m kernel's registers a thread at each padded width on sm_90a:
# nvcc -Xptxas -v's count, the most over the metrics and input types,
# rounded up to the 8 a thread is allocated in.  chip_smoke.py holds the
# residency they give to the occupancy calculator's.
REGISTERS = {8: 64, 16: 80, 24: 104, 32: 128, 40: 128, 48: 168, 64: 200,
             96: 128, 128: 184, 160: 240, 256: 256}


def _resident(rows: int, smem: int, dp: int) -> int:
    """CTAs of the small-m kernel an SM holds at once: by threads, by shared
    memory (an SM's 228 KB, 1 KB of it reserved per CTA) and by registers
    (REGISTERS)."""
    threads = rows // rows_per_thread(dp)
    return max(1, min(MAX_THREADS_PER_SM // threads, MAX_CTAS_PER_SM,
                      SMEM_PER_SM // (smem + 1024),
                      65_536 // (threads * REGISTERS[dp])))


def _row_buf_bytes(rows: int, d: int, dp: int) -> int:
    """pdist.cu: rs_buf_bytes, one tile of rows at pitch DP + 4 words where
    they may come by row (d % 4 == 0), else at pitch d plus 16 bytes."""
    return 4 * rows * (dp + 4) if d % 4 == 0 else 4 * rows * d + 16


def _rowscan_smem(rows: int, mc: int, d: int, dp: int, nbuf: int) -> int:
    """pdist.cu: rs_smem_bytes, two mbarriers, mc centers and their norms at
    pitch DP + 4, nbuf row buffers."""
    return (16 + 4 * mc * (dp + 4) + 4 * (-(-mc // 4) * 4)
            + nbuf * _row_buf_bytes(rows, d, dp))


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, m: int, d: int, how=None) -> LaunchPlan:
    """The kernels' launch shape for an (n, m, d) call on route ``how``
    (None: :func:`route`'s choice; a named route is taken as it is, to
    measure the routes against each other).

    The small-m route (``pdist.cu``: min_argmin_rows_kernel): rows per tile
    follow n, multiples of 32 R (R rows a thread, :func:`rows_per_thread`)
    up to a cap of 256 (128 above d = 128; less where the row buffers would
    pass ROW_BUFS_MAX): the cap once n gives every SM a tile, else the
    largest whose busiest SM holds at most 4% more rows than the best
    split's (tiles handed to SMs in turn); one row buffer, two for
    FEW_CENTERS or fewer; every center and its norm staged once per CTA
    where they fit beside the row buffers (all of them below the tiled
    route's threshold), else in chunks; a persistent grid of as many CTAs
    as the SMs hold at once, up to one per tile (chip_smoke.py's plan
    ladder measures these choices against the others).  The tiled route
    keeps its fixed shape (128-row CTAs, 64-center tiles; ``pdist.cu``
    sizes its shared memory), the chunked route its own (128-row CTAs,
    128-center tiles, fixed shared memory); the generic width (d > 256,
    the small-m route named) its 256-row CTAs."""
    way = how or route(n, m, d)
    dp = padded_width(d)
    if way == "tiled":
        return LaunchPlan("tiled", TL_BM, -(-n // TL_BM), 0, TL_BN, 0)
    if way == "chunked":
        return LaunchPlan("chunked", CK_BM, -(-n // CK_BM), CK_SMEM, CK_BN,
                          0)
    if dp == 0:
        return LaunchPlan("rowscan", 256, -(-n // 256), 0, m, 0)
    nt = 128 if dp > 128 else 256
    nbuf = 2 if m <= FEW_CENTERS else 1
    step = 32 * rows_per_thread(dp)
    cap = min(nt, step * max(1, ROW_BUFS_MAX
                             // (nbuf * _row_buf_bytes(step, d, dp))))
    if n >= SMS * cap:
        rows = cap
    else:
        costs = {r: -(-(-(-n // r)) // SMS) * r
                 for r in range(cap, 0, -step)}
        low = min(costs.values())
        rows = next(r for r, cost in costs.items() if cost <= BALANCE * low)
    left = SMEM_MAX - _rowscan_smem(rows, 0, d, dp, nbuf) - 12
    mc = max(1, min(m, left // (4 * (dp + 5))))
    smem = _rowscan_smem(rows, mc, d, dp, nbuf)
    tiles = -(-n // rows)
    grid = min(tiles, SMS * _resident(rows, smem, dp))
    return LaunchPlan("rowscan", rows, grid, smem, mc, nbuf)


@functools.lru_cache(maxsize=1024)
def _rowscan_args(n: int, m: int, d: int, metric: str, dtype,
                  plan: LaunchPlan):
    """The small-m C entry's ten ints for one call (``pdist.cu``:
    rt_min_argmin): n, m, d, the metric and dtype codes and ``plan``'s
    rows, grid, shared memory, centers and buffers, as one ctypes array
    made once per call shape, so a launch hands ctypes five arguments, not
    fourteen."""
    return (ctypes.c_int * 10)(n, m, d, METRIC_CODES[metric],
                               DTYPE_CODES[dtype], plan.rows, plan.grid,
                               plan.smem_bytes, plan.centers, plan.buffers)


def split_outputs(buf: torch.Tensor, n: int):
    """(dist, idx) views of a call's one float32 buffer, (2, n) or flat with
    scratch past 2n words: its first n words, and the next n as int32."""
    rows = buf if buf.dim() == 2 else buf[:2 * n].view(2, n)
    dist, idx = rows.unbind(0)
    return dist, idx.view(torch.int32)


def _launch(kern, x: torch.Tensor, c: torch.Tensor, *, metric: str = "l2sq"):
    out = _launch_route(None, x, c, metric=metric)
    if x.device.type == "cuda":
        kern.launches += 1
    return out


def _launch_route(how, x: torch.Tensor, c: torch.Tensor, *,
                  metric: str = "l2sq"):
    """The kernel on route ``how``: None for :func:`route`'s choice, or
    one of ROUTES (a measurement of the routes against each other), with
    no launch counted: :func:`min_argmin_cuda` calls it with None.  On a
    CPU tensor it is the plain version.

    One float32 buffer per call, fresh on every call (a caller may keep the
    previous results): ``dist``, ``idx`` (an int32 view) and, on the tiled
    and chunked routes, their m words of center norms."""
    if x.device.type == "cpu":
        from repro_torch.kernels.pdist.ops import min_argmin_blocked
        return min_argmin_blocked(x, c, metric=metric)
    check_operands(x, c, metric, "min_argmin_cuda")
    n, d = x.shape
    m = c.shape[0]
    if how not in (None, *ROUTES) or (how == "tiled" and d > TILED_MAX_D):
        raise ValueError(f"min_argmin_cuda: route {how!r} does not take "
                         f"d = {d}; routes {ROUTES}, tiled for d <= "
                         f"{TILED_MAX_D}")
    plan = launch_plan(n, m, d, how)
    if plan.route != "rowscan":
        buf = torch.empty((2 * n + m,), dtype=torch.float32, device=x.device)
        ptr = buf.data_ptr()
        fn = _build.bind("pdist", f"rt_min_argmin_{plan.route}", 5, 5)
        err = fn(x.data_ptr(), c.data_ptr(), ptr + 8 * n, ptr, ptr + 4 * n,
                 n, m, d, METRIC_CODES[metric], DTYPE_CODES[x.dtype],
                 _build.stream_ptr(x))
    else:
        buf = torch.empty((2, n), dtype=torch.float32, device=x.device)
        fn = _build.bind("pdist", "rt_min_argmin", 4, 0)
        err = fn(x.data_ptr(), c.data_ptr(), buf.data_ptr(),
                 _rowscan_args(n, m, d, metric, x.dtype, plan),
                 _build.stream_ptr(x))
    _build.check(err, "min_argmin_cuda")
    return split_outputs(buf, n)


def _flops(x, c, **_) -> float:
    """3 a (row, center, feature): difference, product, sum."""
    return 3.0 * x.shape[0] * c.shape[0] * x.shape[1]


min_argmin_cuda = _build.CudaKernel("min_argmin", _launch, _flops)
