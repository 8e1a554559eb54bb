"""min_argmin's CPU-visible launch path (``kernels/pdist/kernel.py``): the
small-m route's launch plan (rows per CTA from n, a persistent grid, every
center staged at once below the tiled route's threshold), the one output
buffer and its views, the launch counter, the byte spans of the kernel's
bulk copies, and the CPU path of ``min_argmin`` against the reference's
``min_argmin_pallas`` in interpret mode on both sides of the threshold.
The kernel itself runs only on the card (``chip_smoke.py`` holds it to its
plain version and, bit for bit, to the tiled route and ``score``'s (dist,
idx) at these edges).

Tolerances are ``tests/test_torch_kernels.py``'s: distances rtol/atol 1e-5
against the reference, argmins equal.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.pdist.kernel import min_argmin_pallas
from repro_torch.kernels.pdist import kernel as pk
from repro_torch.kernels.pdist.kernel import (CK_SMEM, PADDED_WIDTHS,
                                              SMEM_MAX, SMS, TILED_MAX_D,
                                              LaunchPlan, chunked_min_m,
                                              launch_plan, min_argmin_cuda,
                                              padded_width, route,
                                              split_outputs, tiled_min_m)
from repro_torch.kernels.pdist.ops import min_argmin, min_argmin_blocked

torch.set_num_threads(1)

STATIC_SMEM_MAX = 48 * 1024    # bytes a CTA gets without opting in
NS = (0, 1, 32, 4_224, 4_225, 50_250, 10**6)
# one d per padded width, the main path's (5, 32, 34) among them, and the
# generic width past 256
WIDTHS = (1, 5, 16, 24, 32, 34, 48, 64, 65, 128, 130, 256, 300)


def _small_ms(d):
    """Center counts of the small-m route at width d: 3 and one below the
    tiled or chunked route's threshold (none past d = 256, where the
    chunked route takes every m)."""
    least = tiled_min_m(d) or chunked_min_m(d)
    return tuple(m for m in (3, least - 1) if 1 <= m < least)


def _smem(rows, mc, d, dp, nbuf):
    """pdist.cu: rs_smem_bytes, written out again."""
    buf = 4 * rows * (dp + 4) if d % 4 == 0 else 4 * rows * d + 16
    return 16 + 4 * mc * (dp + 4) + 4 * (-(-mc // 4) * 4) + nbuf * buf


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("d", WIDTHS)
def test_launch_plan_shape(n, d):
    dp = padded_width(d)
    if dp == 0:    # the generic width, named, keeps its 256-row CTAs
        for m in (3, 2_048):
            assert launch_plan(n, m, d, "rowscan") == LaunchPlan(
                "rowscan", 256, -(-n // 256), 0, m, 0)
            assert launch_plan(n, m, d).route == ("chunked" if n else
                                                  "rowscan")
    for m in _small_ms(d):
        plan = launch_plan(n, m, d)
        assert plan.route == "rowscan" == route(n, m, d)
        tiles = -(-n // plan.rows)
        nt = 128 if dp > 128 else 256
        r = pk.rows_per_thread(dp)
        # whole warps of R rows a thread, at most 256 rows (128 past 128)
        assert plan.rows % (32 * r) == 0 and 32 * r <= plan.rows <= nt
        # a persistent grid: at most one CTA per tile, the tiles cover n
        if n == 0:
            assert plan.grid == 0
        else:
            assert 1 <= plan.grid <= tiles
            assert (tiles - 1) * plan.rows < n <= tiles * plan.rows
            assert plan.grid <= SMS * pk._resident(plan.rows,
                                                   plan.smem_bytes, dp)
        assert 1 <= plan.centers <= m
        # two row buffers only where a tile's scan is short (few centers)
        assert plan.buffers == (2 if m <= pk.FEW_CENTERS else 1)
        assert plan.smem_bytes == _smem(plan.rows, plan.centers, d, dp,
                                        plan.buffers)
        assert plan.smem_bytes <= SMEM_MAX
        if plan.smem_bytes > STATIC_SMEM_MAX:
            assert plan.smem_bytes <= 232_448       # the sm_90 opt-in


@pytest.mark.parametrize("n, m, d, rows, grid", [
    (1, 3, 34, 64, 1),               # one warp of two rows a thread
    (32, 3, 34, 64, 1),
    (4_224, 3, 34, 64, 66),
    (4_225, 3, 34, 64, 67),
    (16_384, 40, 5, 128, 128),       # the stream's merge round
    (50_250, 200, 5, 256, 197),      # gauss's Alg. 1 round
    (65_536, 200, 32, 256, 256),     # cluster_dryrun's site round
    (244_922, 26, 34, 256, 528),     # kdd's Alg. 1 round: 4 CTAs an SM
    (1_048_576, 20, 5, 256, 1_056),  # the stream's refit assignment
    (4_898_431, 3, 34, 256, 396),    # kdd's losses: 48-49 tiles a CTA
])
def test_launch_plan_main_path(n, m, d, rows, grid):
    plan = launch_plan(n, m, d)
    assert (plan.rows, plan.grid, plan.centers) == (rows, grid, m)


@pytest.mark.parametrize("n", [1, 4_225, 16_384, 33_792, 50_250, 244_922,
                               4_898_431])
@pytest.mark.parametrize("d", [5, 34, 64, 130])
def test_launch_plan_balances_the_sms(n, d):
    """Once every SM gets a tile of the cap's rows the plan takes the cap;
    below, tiles go to the SMs in turn, so the busiest SM holds ceil(tiles
    / 132) tiles: the plan's rows keep that within BALANCE of the best
    multiple of 32 R, and no larger multiple does as well."""
    plan = launch_plan(n, 3, d)
    dp = padded_width(d)
    step = 32 * pk.rows_per_thread(dp)
    cap = max(r for r in range(step, (128 if dp > 128 else 256) + 1, step)
              if plan.buffers * pk._row_buf_bytes(r, d, dp)
              <= pk.ROW_BUFS_MAX or r == step)
    if n >= SMS * cap:
        assert plan.rows == cap
        return
    busiest = lambda r: -(-(-(-n // r)) // SMS) * r          # noqa: E731
    best = min(busiest(r) for r in range(step, cap + 1, step))
    assert busiest(plan.rows) <= pk.BALANCE * best
    assert all(busiest(r) > pk.BALANCE * best
               for r in range(plan.rows + step, cap + 1, step))


def test_resident_ctas_follow_the_registers():
    """The persistent grid holds as many CTAs as threads, shared memory and
    REGISTERS allow an SM: the stream's refit (8 of 128 threads at 64
    registers) and kdd's round (4 by registers: 128 threads at 128)."""
    plan = launch_plan(1_048_576, 20, 5)
    assert pk._resident(plan.rows, plan.smem_bytes, 8) == 8
    assert plan.grid == SMS * 8
    plan = launch_plan(244_922, 26, 34)
    assert pk._resident(plan.rows, plan.smem_bytes, 40) == 4
    assert set(pk.REGISTERS) == set(PADDED_WIDTHS)


@pytest.mark.parametrize("d", range(1, TILED_MAX_D + 1))
def test_every_center_below_the_threshold_fits(d):
    """Below the tiled route's threshold every center and its norm is
    staged once per CTA, at any n."""
    m = tiled_min_m(d) - 1
    for n in (1, 4_225, 244_922, 4_898_431):
        plan = launch_plan(n, m, d)
        assert plan.route == "rowscan" and plan.centers == m
        assert plan.smem_bytes <= SMEM_MAX
        assert launch_plan(n, m + 1, d).route == "tiled"


def test_wide_rows_stage_centers_in_chunks():
    """Past the tiled route's widths many centers do not fit at once: they
    come in chunks that do, each at least a warp's worth (the small-m
    route named; such a call is the chunked route's)."""
    plan = launch_plan(3_001, 2_048, 130, "rowscan")
    assert 32 <= plan.centers < 2_048 and plan.smem_bytes <= SMEM_MAX
    assert launch_plan(3_001, 2_048, 130).route == "chunked"


def test_plan_is_cached_per_n_m_d():
    launch_plan.cache_clear()
    first = launch_plan(244_922, 26, 34)
    assert launch_plan(244_922, 26, 34) is first
    info = launch_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    # a named route is its own entry; the tiled one keeps its fixed shape
    tiled = launch_plan(244_922, 26, 34, "tiled")
    assert tiled.route == "tiled" and tiled.rows == pk.TL_BM
    assert tiled.grid == -(-244_922 // pk.TL_BM)
    assert launch_plan(244_922, 26, 34) is first


# The three cells' call shapes at d = 34 and 18 (Alg. 1's rounds and Alg.
# 2's reassignment at each site size, the second level's last assignment,
# the warm call) and their plans, as they were before the chunked route:
# routes and plans there do not move.
CELL_PLANS = {
    (244_921, 26, 34): ("rowscan", 256, 528, 39_536, 26, 1),      # kdd
    (244_921, 36_537, 34): ("tiled", 128, 1_914, 0, 64, 0),
    (244_922, 26, 34): ("rowscan", 256, 528, 39_536, 26, 1),
    (244_922, 36_537, 34): ("tiled", 128, 1_914, 0, 64, 0),
    (874_751, 3, 34): ("rowscan", 256, 396, 70_224, 3, 2),
    (250_000, 200, 18): ("rowscan", 256, 528, 41_664, 200, 1),    # susy
    (250_000, 5_401, 18): ("tiled", 128, 1_954, 0, 64, 0),
    (151_962, 100, 18): ("rowscan", 256, 528, 30_064, 100, 1),
    (1_224_607, 30, 34): ("rowscan", 256, 528, 40_256, 30, 1),    # kdd4
    (1_224_607, 182_281, 34): ("tiled", 128, 9_568, 0, 64, 0),
    (1_460_000, 3, 34): ("rowscan", 256, 396, 70_224, 3, 2),
    (1, 1, 34): ("rowscan", 64, 1, 17_648, 1, 2),                  # warm
    (1, 1, 18): ("rowscan", 64, 1, 9_392, 1, 2),
}


@pytest.mark.parametrize("shape", list(CELL_PLANS))
def test_cells_keep_their_routes_and_plans(shape):
    plan = launch_plan(*shape)
    assert tuple(plan) == CELL_PLANS[shape]
    assert route(*shape) == plan.route


def test_chunked_plan_is_fixed():
    """The chunked route's shape: 128-row CTAs, 128-center tiles, its fixed
    shared memory (two buffers of 32 coordinates of x and of the centers,
    the rows' x2), whatever m, named at any width."""
    assert CK_SMEM == 4 * (2 * 32 * ((128 + 4) + (128 + 4)) + 128)
    for n, m, d in ((62_500, 10_801, 768), (1, 1, 257), (129, 3, 5)):
        plan = launch_plan(n, m, d, "chunked")
        assert plan == LaunchPlan("chunked", 128, -(-n // 128), CK_SMEM,
                                  128, 0)


def test_plan_named_route_matches_the_routed_one():
    for n, m, d in ((62_500, 10_801, 768), (62_500, 200, 768)):
        assert launch_plan(n, m, d) == launch_plan(n, m, d, "chunked")
    for n, m, d in ((244_922, 36_537, 34), (50_000, 5_001, 5)):
        assert launch_plan(n, m, d) == launch_plan(n, m, d, "tiled")
    for n, m, d in ((244_922, 26, 34), (1, 3, 5)):
        assert launch_plan(n, m, d) == launch_plan(n, m, d, "rowscan")


# --------------------------------------------------------- output buffer
@pytest.mark.parametrize("n, scratch", [(0, 0), (1, 0), (257, 0), (33, 40),
                                        (0, None), (1, None), (257, None)])
def test_split_outputs_views(n, scratch):
    """The small-m route's (2, n) buffer, and the tiled route's flat one
    with its m words of norms past 2n (scratch)."""
    buf = torch.arange(2 * n + (scratch or 0), dtype=torch.float32)
    dist, idx = split_outputs(buf if scratch is not None else buf.view(2, n),
                              n)
    assert dist.shape == idx.shape == (n,)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    assert dist.untyped_storage().data_ptr() == buf.data_ptr()
    if n:
        assert dist.data_ptr() == buf.data_ptr()
        assert idx.data_ptr() == buf.data_ptr() + 4 * n
    # writes through the views land in the buffer's first 2n words
    dist.fill_(-1.0)
    idx.fill_(7)
    assert bool((buf[:n] == -1.0).all())
    assert bool((buf[n:2 * n].view(torch.int32) == 7).all())
    assert torch.equal(buf[2 * n:], torch.arange(2 * n, 2 * n + (scratch or 0),
                                                 dtype=torch.float32))


# --------------------------------------------------------- launch counter
def test_launch_counter_moves_only_on_cuda(monkeypatch):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(40, 5)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32))
    before = min_argmin_cuda.launches
    d1, i1 = min_argmin_cuda(x, c)
    assert min_argmin_cuda.launches == before           # plain on the CPU
    d2, i2 = min_argmin_blocked(x, c)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    # a tensor on the card (stood in for: only its device is read) counts
    # one launch per wrapper call
    calls = []
    monkeypatch.setattr(pk, "_launch_route",
                        lambda how, x, c, *, metric: calls.append(how) or 0)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    for _ in range(3):
        min_argmin_cuda(on_card, c)
    assert min_argmin_cuda.launches == before + 3 and calls == [None] * 3


# ------------------------------------------------------ bulk-copy spans
def _spans(addr, cnt, es):
    """The kernel's split of a tile of cnt elements of es bytes at global
    address addr (pdist.cu: BlockSpan): (the elements its readers load from
    global memory, the bulk copy's first byte offset and length), the tile
    placed at the buffer's byte offset addr % 16."""
    nbytes = cnt * es
    shift = addr & 15
    head = min(nbytes, (16 - shift) & 15)
    body = (nbytes - head) & ~15
    h, tail0 = head // es, (head + body) // es
    plain = list(range(h)) + list(range(tail0, cnt))
    return plain, head, body, shift


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("d", [1, 5, 8, 32, 34, 64])
@pytest.mark.parametrize("rows", [1, 31, 33, 256])
def test_bulk_spans_cover_the_tile_once(es, d, rows):
    cnt = rows * d
    for addr in range(0x1000, 0x1010, es):
        plain, head, body, shift = _spans(addr, cnt, es)
        # the bulk copy: 16-byte multiple, 16-byte aligned at both ends (in
        # global memory and at its place in the buffer)
        assert body % 16 == 0 and body >= 0
        assert body == 0 or ((addr + head) % 16 == 0
                             and (shift + head) % 16 == 0)
        # the ragged ends: under 16 bytes at each end
        assert len(plain) * es < 32
        covered = sorted(plain + list(range(head // es, (head + body) // es)))
        assert covered == list(range(cnt))
        # the buffer holds the tile past its shift (pdist.cu: rs_buf_bytes)
        assert shift + cnt * es <= 4 * rows * d + 16


# ------------------------------------------------- CPU path vs reference
@pytest.mark.parametrize("d", [5, 16, 34, 64])
@pytest.mark.parametrize("side", [-1, 0])
@pytest.mark.parametrize("metric", ["l2sq", "l2", "l1"])
def test_min_argmin_cpu_matches_pallas_at_the_threshold(d, side, metric):
    """m = tiled_min_m(d) - 1 (the small-m route's widest call) and
    tiled_min_m(d) (the tiled route's narrowest): the CPU path of the op
    against the reference kernel in interpret mode."""
    m = tiled_min_m(d) + side
    assert route(100, m, d, metric) == ("rowscan" if side else "tiled")
    rng = np.random.default_rng(d * 10 + side + 3)
    x = rng.normal(size=(100, d)).astype(np.float32)
    c = rng.normal(size=(m, d)).astype(np.float32)
    dk, ak = min_argmin_pallas(jnp.asarray(x), jnp.asarray(c), metric=metric,
                               interpret=True)
    dist, idx = min_argmin(torch.as_tensor(x), torch.as_tensor(c),
                           metric=metric)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ak))


def test_padded_widths_are_the_kernels():
    """Every width the plan names is one pdist.cu instantiates (dispatch_dp),
    the generic path past 256."""
    assert [padded_width(d) for d in (1, 8, 9, 33, 34, 64, 65, 256, 257)] == \
        [8, 8, 16, 40, 40, 64, 96, 256, 0]
    assert all(w % 8 == 0 for w in PADDED_WIDTHS)
