"""The CPU-visible parts of the redesigned CUDA kernels (``csrc/pdist.cu``'s
large-m route, ``csrc/wkv.cu``'s V-sliced chunk sweep and first pass),
against the reference where there is one.

* ``route``: the plain Python choice among min_argmin's three CUDA routes
  (the chunked one past d = 64).
* The tiled route's tie rule: per-thread strict-``<`` scans over the
  thread's columns, then a lexicographic (dist, idx) minimum over the
  threads, is the sequential strict-``<`` scan (emulated here in numpy with
  the kernel's column partition; the kernel itself is held to the rowscan
  route bit for bit on the card by ``chip_smoke.py``).  The chunked route's
  too, with d cut into its chunks: its partial sums carried across the
  chunks are the unchunked chains (emulated in float32 numpy; on the card
  ``tests/test_torch_chunked_chip.py`` holds the kernel to both routes bit
  for bit).
* The WKV grid's decomposition: the columns of S and o along V are
  independent, so the plain version on each V-slice of s0 and v (the other
  columns zero) gives that slice of the whole; held against
  ``wkv_forward_pallas`` in interpret mode, strong decays at c = 64.
* The first pass: ``wkv_chunk_w_plain`` against the reference kernel's own
  w_ts + bonus, read off ``wkv_forward_pallas`` with one chunk per row,
  s0 = 0 and v the identity (then o = w v = w).

Tolerances are ``tests/test_torch_wkv.py``'s: atol 1e-3 against the
reference (f32 sums in other orders), with rtol 1e-4 where exp of
cumulative log-decays of up to ~1,000 sets the conditioning.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.wkv.kernel import wkv_forward_pallas
from repro_torch.kernels.pdist.kernel import (CHUNKED_ALL_D, CK_BM, CK_BN,
                                              CK_SMEM, TILED_MAX_D,
                                              LaunchPlan, _launch_route,
                                              chunked_min_m, launch_plan,
                                              min_argmin_cuda, route,
                                              tiled_min_m)
from repro_torch.kernels.pdist.ops import min_argmin_blocked
from repro_torch.kernels.wkv.kernel import (wkv_chunk_w_cuda,
                                            wkv_chunk_w_plain,
                                            wkv_forward_cuda,
                                            wkv_forward_plain)

torch.set_num_threads(1)


# ------------------------------------------------------------ pdist route
@pytest.mark.parametrize("n, m, d, metric, want", [
    (244_922, 36_537, 34, "l2sq", "tiled"),     # Alg. 2 reassignment
    (244_922, 26, 34, "l2sq", "rowscan"),       # Alg. 1 round
    (4_898_431, 3, 34, "l2", "rowscan"),        # losses
    (256, 3, 34, "l2sq", "rowscan"),            # serving micro-batch
    (10, 176, 34, "l1", "tiled"),
    (10, 175, 34, "l2", "rowscan"),
    (50_000, 5001, 5, "l2sq", "tiled"),         # gauss-0.1 reassignment
    (50_000, 200, 5, "l2sq", "rowscan"),        # gauss-0.1 Alg. 1 round
    (10, 240, 16, "l2sq", "tiled"),
    (10, 239, 33, "l2sq", "rowscan"),
    (10, 176, 64, "l2sq", "tiled"),
    (10, 400, 1, "l2sq", "tiled"),
    (10, 399, 15, "l1", "rowscan"),
    (10, 5000, TILED_MAX_D, "l2sq", "tiled"),
    (10, 5000, TILED_MAX_D + 1, "l2sq", "chunked"),
    (10, 5000, 130, "l1", "chunked"),
    (62_500, 200, 768, "l2sq", "chunked"),     # curation's Alg. 1 round
    (62_500, 10_801, 768, "l2sq", "chunked"),  # curation's reassignment
    (10, 2, 300, "l2", "chunked"),
    (0, 5000, 34, "l2sq", "rowscan"),
    (0, 5000, 768, "l2sq", "rowscan"),
    (10, 5000, 34, "cosine", None),             # no CUDA kernel at all
])
def test_pdist_route_picks_tiled_only_above_threshold(n, m, d, metric, want):
    assert route(n, m, d, metric) == want


def test_pdist_tiled_threshold_never_rises_with_d():
    """More coordinates make a pair cost more on both routes and save more
    on the tiled one, so its threshold must not rise with d."""
    least = [tiled_min_m(d) for d in range(1, TILED_MAX_D + 1)]
    assert all(a >= b for a, b in zip(least, least[1:]))
    assert tiled_min_m(0) is None and tiled_min_m(TILED_MAX_D + 1) is None


@pytest.mark.parametrize("m", [1, 100, 10_000])
@pytest.mark.parametrize("d", [257, 384, 768, 1024])
def test_pdist_route_takes_chunked_past_256_whatever_m(d, m):
    n = 62_500
    assert chunked_min_m(d) == 1 and tiled_min_m(d) is None
    assert route(n, m, d) == "chunked"
    assert launch_plan(n, m, d) == LaunchPlan(
        "chunked", CK_BM, -(-n // CK_BM), CK_SMEM, CK_BN, 0)


def test_pdist_chunked_threshold_between_the_tiled_widths_and_256():
    """Past d = 64 the small-m route keeps only small m, at no width more
    of them than the tiled route keeps at d = 64 (the ladder's crossings:
    PERF.md), the fewest at the widest band; past CHUNKED_ALL_D it keeps
    none."""
    least = [chunked_min_m(d) for d in range(TILED_MAX_D + 1,
                                             CHUNKED_ALL_D + 1)]
    assert all(1 <= m <= tiled_min_m(TILED_MAX_D) for m in least)
    assert least[-1] == min(least)
    assert [chunked_min_m(d) for d in (65, 95, 96, 128, 160, 199, 200)] == [
        88, 88, 56, 48, 88, 88, 24]
    for d in (TILED_MAX_D + 1, 130, CHUNKED_ALL_D):
        m = chunked_min_m(d)
        assert route(10, m - 1, d) == "rowscan"
        assert route(10, m, d) == "chunked"


def test_force_route_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(300, 34)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(700, 34)).astype(np.float32))
    before = min_argmin_cuda.launches
    dp, ap = min_argmin_blocked(x, c)
    for how in ("tiled", "rowscan", "chunked", None):
        d, a = _launch_route(how, x, c)
        assert torch.equal(a, ap) and torch.equal(d, dp)
    d, a = min_argmin_cuda(x, c)
    assert torch.equal(a, ap) and torch.equal(d, dp)
    assert min_argmin_cuda.launches == before


def _sequential_scan(dist):
    """Row-wise strict-< scan in index order: RowScan's rule."""
    best = np.full(dist.shape[0], np.inf, np.float32)
    idx = np.zeros(dist.shape[0], np.int64)
    for j in range(dist.shape[1]):
        take = dist[:, j] < best
        best[take], idx[take] = dist[take, j], j
    return best, idx


def _chunked_owner(j):
    """The chunked route's thread (of 16) for column j: columns tx * 4 ..
    + 3 and 64 + tx * 4 .. + 3 of every tile of 128."""
    return (j % 64) // 4


def _tiled_scan(dist, tile=64, per_thread=4, owner=None):
    """The tiled kernel's order: thread tx owns columns tx * 4 .. tx * 4 + 3
    of every tile of 64 (or those ``owner`` gives it), scans them in index
    order with a strict <, and the 16 threads of a row are reduced by the
    lexicographic (dist, idx) minimum (index sentinel: none found, then
    0)."""
    n, m = dist.shape
    threads = tile // per_thread
    owner = owner or (lambda j: (j % tile) // per_thread)
    sentinel = np.iinfo(np.int64).max
    bests, idxs = [], []
    for tx in range(threads):
        cols = [j for j in range(m) if owner(j) == tx]
        b = np.full(n, np.inf, np.float32)
        i = np.full(n, sentinel)
        for j in cols:
            take = dist[:, j] < b
            b[take], i[take] = dist[take, j], j
        bests.append(b)
        idxs.append(i)
    best, idx = bests[0], idxs[0]
    for b, i in zip(bests[1:], idxs[1:]):
        take = (b < best) | ((b == best) & (i < idx))
        best, idx = np.where(take, b, best), np.where(take, i, idx)
    return best, np.where(idx == sentinel, 0, idx)


@pytest.mark.parametrize("case", ["ties", "inf_rows", "nan", "ragged"])
def test_tiled_reduction_is_the_sequential_scan(case):
    rng = np.random.default_rng(7)
    m = 1000 if case == "ragged" else 4096
    dist = rng.integers(0, 50, size=(64, m)).astype(np.float32)  # many ties
    if case == "ties":
        dist[:, [17, 4095]] = -1.0          # the nearest, twice: answer 17
        dist[3] = 5.0                       # all equal: answer 0
    if case == "inf_rows":
        dist[:, ::7] = np.inf               # Alg. 2's invalid slots
        dist[5] = np.inf                    # nothing finite: index 0
    if case == "nan":
        dist[rng.random(dist.shape) < 0.2] = np.nan   # a NaN never wins
        dist[9] = np.nan
    want_d, want_i = _sequential_scan(dist)
    got_d, got_i = _tiled_scan(dist)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    if case == "ties":
        assert want_i[0] == 17 and want_i[3] == 0


def _fma_chains(x, c, chunk=None):
    """float32 distances x2 + c2 - 2 x.c (max 0) with every sum one chain
    over f in order, step by step in float32; ``chunk``: the chunked
    route's order, the partials carried from each chunk of coordinates to
    the next (x2 summed in the first tile's chunks), else one pass."""
    n, d = x.shape
    bounds = [(0, d)] if chunk is None else [
        (f0, min(d, f0 + chunk)) for f0 in range(0, d, chunk)]
    dot = np.zeros((n, c.shape[0]), np.float32)
    x2 = np.zeros(n, np.float32)
    c2 = np.zeros(c.shape[0], np.float32)
    for f0, f1 in bounds:
        for f in range(f0, f1):
            dot = (dot + np.float32(x[:, f:f + 1] * c[None, :, f])
                   ).astype(np.float32)
            x2 = (x2 + x[:, f] * x[:, f]).astype(np.float32)
            c2 = (c2 + c[:, f] * c[:, f]).astype(np.float32)
    dist = (x2[:, None] + c2[None, :]).astype(np.float32) \
        - np.float32(2.0) * dot
    return np.maximum(dist.astype(np.float32), np.float32(0.0))


@pytest.mark.parametrize("d", [3, 32, 33, 100])
def test_chunked_reduction_is_the_sequential_scan(d):
    """The chunked route's order (chunks of 32 coordinates, the partials
    carried across them, then its column partition and the lexicographic
    minimum) gives the unchunked chains' distances and the sequential
    strict-< scan's index, planted ties included: duplicate centers in one
    thread's columns (5, 6 and 69), across tiles (130) and in the ragged
    last tile, and rows equal to them."""
    rng = np.random.default_rng(d)
    x = rng.integers(-2, 3, size=(40, d)).astype(np.float32)
    c = rng.integers(-2, 3, size=(203, d)).astype(np.float32)
    c[6] = c[69] = c[130] = c[5]
    c[202] = c[7]
    x[0], x[1] = c[5], c[7]
    dist = _fma_chains(x, c, chunk=32)
    np.testing.assert_array_equal(dist, _fma_chains(x, c))
    want_d, want_i = _sequential_scan(dist)
    assert _chunked_owner(5) == _chunked_owner(6) == _chunked_owner(69)
    got_d, got_i = _tiled_scan(dist, tile=128, owner=_chunked_owner)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_i[0] == 5 and got_i[1] == 7
    assert len(set(dist[2].tolist())) < dist.shape[1]     # ties happen


# ------------------------------------------------------------------ WKV
def _inputs(BH, T, K, seed, per_row_u=True, decay=(-6, 3)):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, T, K)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.uniform(*decay, size=(BH, T, K)))).astype(np.float32)
    u = rng.normal(size=(BH, K) if per_row_u else (K,)).astype(np.float32)
    s0 = rng.normal(size=(BH, K, K)).astype(np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("BH, T, K, c, vb", [
    (4, 128, 64, 64, 16),      # strong decays at c = 64: |lw| up to e^3
    (3, 64, 64, 16, 16),       # the serving shape's chunk and slice
    (2, 48, 32, 24, 16),
    (5, 40, 16, 5, 8),
])
def test_wkv_v_slices_compose_the_whole(BH, T, K, c, vb):
    arrs = _inputs(BH, T, K, BH + T + c)
    r, k, v, lw, u, s0 = (torch.from_numpy(a) for a in arrs)
    ok, sk = wkv_forward_pallas(*(jnp.asarray(a) for a in arrs), chunk=c,
                                interpret=True)
    o_whole, s_whole = wkv_forward_plain(r, k, v, lw, u, s0, chunk=c)
    o_cat, s_cat = [], []
    for x0 in range(0, K, vb):
        keep = torch.zeros(K, dtype=torch.bool)
        keep[x0:x0 + vb] = True
        o, s = wkv_forward_plain(r, k, v * keep, lw, u, s0 * keep, chunk=c)
        # the other columns see zero v and zero state: they stay zero
        assert not o[..., ~keep].any() and not s[..., ~keep].any()
        o_cat.append(o[..., keep])
        s_cat.append(s[..., keep])
    o_cat, s_cat = torch.cat(o_cat, -1), torch.cat(s_cat, -1)
    torch.testing.assert_close(o_cat, o_whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_cat, s_whole, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o_cat.numpy(), np.asarray(ok), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(s_cat.numpy(), np.asarray(sk), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("BH, T, K, c, per_row_u, decay", [
    (4, 64, 64, 16, True, (-1.5, 0.5)),     # around the model's init
    (3, 128, 64, 64, False, (-6, 3)),       # strong decays at c = 64
    (6, 48, 32, 24, True, (-6, 3)),
    (2, 35, 16, 7, False, (-6, 3)),
])
def test_first_pass_matches_reference_kernels_w(BH, T, K, c, per_row_u,
                                                decay):
    """The reference kernel's w_ts + bonus, one chunk per row: with s0 = 0
    and v = [I_c | 0] the Pallas kernel's o is w itself."""
    r, k, _, lw, u, _ = _inputs(BH, T, K, 2 * T + c, per_row_u, decay)
    nc = T // c
    chunks = lambda a: a.reshape(BH * nc, c, K)        # noqa: E731
    u_rows = np.repeat(u if per_row_u else u[None].repeat(BH, 0), nc, 0)
    eye = np.zeros((BH * nc, c, K), np.float32)
    eye[:, np.arange(c), np.arange(c)] = 1.0
    o, _ = wkv_forward_pallas(jnp.asarray(chunks(r)), jnp.asarray(chunks(k)),
                              jnp.asarray(eye), jnp.asarray(chunks(lw)),
                              jnp.asarray(u_rows),
                              jnp.zeros((BH * nc, K, K), jnp.float32),
                              chunk=c, block_bh=1, interpret=True)
    want = np.asarray(o)[:, :, :c].reshape(BH, nc, c, c)
    args = [torch.from_numpy(a) for a in (r, k, lw, u)]
    got = wkv_chunk_w_plain(*args, chunk=c)
    assert got.shape == (BH, nc, c, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
    assert not np.triu(got.numpy(), 1).any()           # nothing above
    # on a CPU tensor the kernel's entry is the plain version
    before = wkv_forward_cuda.launches
    assert torch.equal(wkv_chunk_w_cuda(*args, chunk=c), got)
    assert wkv_forward_cuda.launches == before


@pytest.mark.parametrize("per_row_u", [True, False])
def test_wkv_forward_cuda_on_cpu_is_the_plain_version(per_row_u):
    arrs = [torch.from_numpy(a) for a in _inputs(3, 32, 16, 1, per_row_u)]
    o, s = wkv_forward_plain(*arrs, chunk=16)
    before = wkv_forward_cuda.launches
    o2, s2 = wkv_forward_cuda(*arrs, chunk=16)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert wkv_forward_cuda.launches == before
