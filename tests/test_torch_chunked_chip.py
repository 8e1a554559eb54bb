"""The d-chunked distance tile on the card: ``csrc/pdist.cu``'s chunked
route of ``min_argmin`` and ``csrc/lloyd.cu``'s chunked Lloyd step, held to
their plain versions (``kernels/pdist/ref.py``, ``kernels/lloyd/ref.py``).

Every case is marked ``chip`` and skips without a CUDA card; on a card
(this file imports no JAX)::

    python -m pytest tests/test_torch_chunked_chip.py -m chip

Shapes are ragged (n % 128 != 0, m % 64 != 0) and carry planted ties:
duplicate centers in one thread's columns and across 64-center tiles, and
rows equal to a duplicated center.  Tolerances, and why: the kernel sums
x2, c2 and x.c each as one f32 chain over d, the plain version by a matrix
product in another order, so each sum is off by at most ~d eps its
absolute terms; a distance (x2 + c2 - 2 x.c, or the l1 chain) is therefore
held within ``TOL_EPS * d * eps * (|x|^2 + max |c|^2)`` (l1, a sum of
positive terms: times the nearest distance itself) of the float64
distance, and an index must equal the plain version's where the float64
margin to the second nearest center exceeds twice that (three rows in four
or more, or the case says too little).  The chunked route runs the same
chains as the small-m route's (the sequential strict-``<`` scan) and the
tiled route's, so against those it is held bit for bit; so are the Lloyd
step's sums against the serial route's (the same split of rows, the same
order) and across two runs.
"""
import pytest
import torch

from repro_torch.kernels.lloyd import kernel as lk
from repro_torch.kernels.lloyd.ref import lloyd_step_ref
from repro_torch.kernels.pdist import kernel as pk
from repro_torch.kernels.pdist.ref import min_argmin_ref

EPS = 2.0 ** -24
TOL_EPS = 4.0
WIDTHS = (65, 257, 768, 1024)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def card():
    """The CUDA card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _operands(n, m, d, dtype, seed):
    """(x, c, tied rows, the smaller index each tied row must take) on the
    CPU: unit-variance rows, duplicate centers (5, 6 and 69 in one thread's
    columns; 5 and 130 across 128-center tiles; 7 and m - 1 in the last,
    ragged tile), and the first rows equal to those centers."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    c = torch.randn((m, d), generator=g)
    c[6] = c[69] = c[130] = c[5]
    c[m - 1] = c[7]
    x[0], x[1], x[2] = c[5], c[7], c[130]
    return x.to(dtype), c.to(dtype), torch.tensor([0, 1, 2]), \
        torch.tensor([5, 7, 5])


def _exact(x, c, metric):
    """float64 distances (n, m) of the upcast inputs, and each row's
    tolerance (module docstring)."""
    xd, cd = x.double(), c.double()
    d = x.shape[1]
    if metric == "l1":
        dist = torch.cat([(xd[i:i + 64, None] - cd[None]).abs().sum(-1)
                          for i in range(0, xd.shape[0], 64)])
        scale = dist.min(1).values
    else:
        x2, c2 = (xd * xd).sum(1), (cd * cd).sum(1)
        dist = (x2[:, None] + c2[None] - 2.0 * xd @ cd.T).clamp(min=0.0)
        scale = x2 + c2.max()
    return dist, TOL_EPS * d * EPS * scale


def _held_to_exact(got_d, got_i, x, c, metric, tied, want):
    dist, tol = _exact(x, c, metric)
    got_d, got_i = got_d.cpu().double(), got_i.cpu().long()
    if metric == "l2":
        got_d = got_d * got_d
    two = dist.topk(2, dim=1, largest=False)
    best, margin = two.values[:, 0], two.values[:, 1] - two.values[:, 0]
    assert ((got_d - best).abs() <= tol).all()
    ref_d, ref_i = min_argmin_ref(x, c, metric)
    clear = margin > 2.0 * tol
    assert clear.double().mean() > 0.75
    assert torch.equal(got_i[clear], ref_i.long()[clear])
    assert torch.equal(got_i[tied], want)


@pytest.mark.chip
@pytest.mark.parametrize("metric", ["l2sq", "l2", "l1"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_chunked_min_argmin_against_plain(card, d, dtype, metric):
    n, m = 1_037, 603
    x, c, tied, want = _operands(n, m, d, dtype, seed=d)
    xc, cc = x.to(card), c.to(card)
    got_d, got_i = pk._launch_route("chunked", xc, cc, metric=metric)
    assert pk.route(n, m, d, metric) == "chunked"
    _held_to_exact(got_d, got_i, x, c, metric, tied, want)
    # the small-m route's sequential strict-< scan, bit for bit
    seq_d, seq_i = pk._launch_route("rowscan", xc, cc, metric=metric)
    assert torch.equal(got_i, seq_i)
    assert torch.equal(got_d.view(torch.int32), seq_d.view(torch.int32))


@pytest.mark.chip
@pytest.mark.parametrize("metric", ["l2sq", "l1"])
@pytest.mark.parametrize("d", [1, 5, 31, 33, 34, 64])
def test_chunked_is_the_tiled_route_bit_for_bit(card, d, metric):
    """At the tiled route's widths (one partial chunk, a whole chunk and a
    ragged second) the chunked tile gives the tiled route's bits."""
    n, m = 4_099, 1_000
    x, c, tied, want = _operands(n, m, d, torch.float32, seed=100 + d)
    xc, cc = x.to(card), c.to(card)
    a_d, a_i = pk._launch_route("chunked", xc, cc, metric=metric)
    b_d, b_i = pk._launch_route("tiled", xc, cc, metric=metric)
    assert torch.equal(a_i, b_i)
    assert torch.equal(a_d.view(torch.int32), b_d.view(torch.int32))


@pytest.mark.chip
def test_chunked_at_the_curation_site(card):
    """The curation cell's reassignment shape at d = 768 on unit rows (a
    site's 62,500 rows against 5,000 of them as centers, one invalid slot
    at 1e30) against the sequential scan bit for bit, and every row's
    distance to the center it names within the tolerance of float64."""
    g = torch.Generator().manual_seed(768)
    x = torch.nn.functional.normalize(torch.randn((62_500, 768),
                                                  generator=g), dim=1)
    c = x[torch.randperm(62_500, generator=g)[:5_001]].clone()
    c[4_000] = 1e30
    xc, cc = x.to(card), c.to(card)
    got_d, got_i = pk._launch_route(None, xc, cc)
    assert pk.launch_plan(62_500, 5_001, 768).route == "chunked"
    seq_d, seq_i = pk._launch_route("rowscan", xc, cc)
    assert torch.equal(got_i, seq_i)
    assert torch.equal(got_d.view(torch.int32), seq_d.view(torch.int32))
    assert not (got_i == 4_000).any()
    pick = c.double()[got_i.cpu().long()]
    exact = ((x.double() - pick) ** 2).sum(1)
    assert ((got_d.cpu().double() - exact).abs()
            <= TOL_EPS * 768 * EPS * 2.0).all()


def _lloyd(route, x, w, c):
    plan = lk.lloyd_plan(x.shape[0], c.shape[0], x.shape[1], route)
    return lk._launch_route(plan, x, w, c)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("k", [3, 67])
def test_chunked_lloyd_step_against_plain(card, d, k, dtype):
    """The chunked Lloyd step (the route past d = 160; named at d = 65):
    its assignment and dist are the chunked min_argmin's bit for bit and
    the plain version's within the tolerance; its sums and counts are the
    serial route's bit for bit (same rows a CTA, same order), equal across
    two runs, and within f32 summation error of float64 sums under its own
    assignment."""
    n = 3_001
    x, c, _, _ = _operands(n, 131, d, dtype, seed=d)
    c = c[:k].contiguous()        # ties: min_argmin's cases above
    none = torch.zeros((0,), dtype=torch.long)
    g = torch.Generator().manual_seed(d + k)
    w = torch.rand((n,), generator=g) * 3.0
    xc, wc, cc = x.to(card), w.to(card), c.to(card)
    if d > 160:
        assert lk.lloyd_plan(n, k, d).route == "chunked"
    sums, counts, assign, dist = _lloyd("chunked", xc, wc, cc)
    a_d, a_i = pk._launch_route("chunked", xc, cc)
    assert torch.equal(assign, a_i)
    assert torch.equal(dist.view(torch.int32), a_d.view(torch.int32))
    _held_to_exact(dist, assign, x, c, "l2sq", none, none)
    r_sums, r_counts, r_assign, _ = lloyd_step_ref(x, w, c)
    clear = r_assign.long() == assign.cpu().long()
    assert clear.double().mean() > 0.9
    again = _lloyd("chunked", xc, wc, cc)
    serial = _lloyd("serial", xc, wc, cc)
    for got in (again, serial):
        assert torch.equal(got[0].view(torch.int32), sums.view(torch.int32))
        assert torch.equal(got[1].view(torch.int32),
                           counts.view(torch.int32))
    # float64 sums under the kernel's own assignment; a sequential f32 sum
    # of t terms is within (t - 1) eps of their absolute sum
    a = assign.cpu().long()
    wx = x.double() * w.double()[:, None]
    ref = torch.zeros((k, d), dtype=torch.float64).index_add_(0, a, wx)
    mag = torch.zeros((k, d), dtype=torch.float64).index_add_(0, a,
                                                              wx.abs())
    rows = torch.bincount(a, minlength=k).double()[:, None]
    assert ((sums.cpu().double() - ref).abs()
            <= 2.0 * rows * EPS * mag + 1e-30).all()
    ref_c = torch.zeros((k,), dtype=torch.float64).index_add_(
        0, a, w.double())
    assert ((counts.cpu().double() - ref_c).abs()
            <= 2.0 * rows[:, 0] * EPS * ref_c).all()
    # where the plain version assigns as the kernel does, its counts agree
    if bool(clear.all()):
        assert torch.allclose(counts.cpu(), r_counts, rtol=1e-5)
        assert torch.allclose(sums.cpu(), r_sums, rtol=1e-4, atol=1e-4)


@pytest.mark.chip
def test_chunked_lloyd_at_the_curation_second_level(card):
    """The curation cell's Lloyd step shape (~366k unit records x 100
    centers x 768): bit for bit the serial route's at the same split."""
    g = torch.Generator().manual_seed(769)
    x = torch.nn.functional.normalize(torch.randn((366_000, 768),
                                                  generator=g), dim=1)
    w = torch.randint(1, 20, (366_000,), generator=g).float()
    c = x[torch.randperm(366_000, generator=g)[:100]].clone()
    xc, wc, cc = x.to(card), w.to(card), c.to(card)
    got = _lloyd(None, xc, wc, cc)
    ref = _lloyd("serial", xc, wc, cc)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
