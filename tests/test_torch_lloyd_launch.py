"""The fused Lloyd step's CPU-visible launch path
(``kernels/lloyd/kernel.py``): the kernels' launch shape and route from
``lloyd_plan``, the one output buffer cut into the four results, and the
CPU path of ``lloyd_step`` against the reference's ``lloyd_step_pallas`` in
interpret mode at the widths the kernel routes on.  The kernels run only
on the card (``chip_smoke.py`` holds their assignment to ``min_argmin_cuda``
bit for bit and their sums to the one-hot matmul at these shapes).

Tolerances are ``tests/test_torch_kernels_fused.py``'s for the Lloyd step:
sums rtol/atol 1e-4, counts and distances 1e-5, argmins equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lloyd.kernel import lloyd_step_pallas
from repro_torch.kernels.lloyd.kernel import (CHUNKED_FROM_D, FEW_CENTERS,
                                              MAX_CTAS, ROUTES, SMEM_MAX,
                                              LloydPlan, lloyd_plan,
                                              lloyd_step_cuda, split_outputs)
from repro_torch.kernels.pdist.kernel import CK_SMEM
from repro_torch.kernels.lloyd.ops import lloyd_step, lloyd_step_blocked
from repro_torch.kernels.pdist.kernel import padded_width

torch.set_num_threads(1)

STATIC_SMEM_MAX = 48 * 1024    # bytes a CTA gets without opting in


# ------------------------------------------------------------ launch plan
# (n, k, d) -> (route, rows per CTA, CTAs)
PLANS = {
    (0, 3, 34): ("centers", 256, 0),
    (1, 3, 34): ("centers", 256, 1),
    (257, 3, 34): ("centers", 256, 2),                 # NT + 1
    (874_751, 3, 34): ("centers", 13 * 256, 263),      # kdd second level
    (180_040, 100, 5): ("rows", 3 * 256, 235),         # gauss
    (1000, 37, 18): ("rows", 256, 4),                  # ragged
    (1000, 1, 5): ("centers", 256, 4),                 # k = 1
    (1000, 5, 5): ("rows", 256, 4),                    # past FEW_CENTERS
    (1_049_576, 3, 34): ("centers", 16 * 256, 257),    # ragged last CTA
    (1025, 3, 130): ("centers", 128, 9),               # past d = 128
    (1025, 20, 130): ("serial", 128, 9),               # rows' blocks too big
    (874_751, 100, 34): ("serial", 13 * 256, 263),     # rows' blocks too big
    (3001, 2048, 130): ("serial", 128, 24),            # k2048_d130
    (517, 65, 300): ("chunked", 256, 3),               # generic width
    (600, 3, 200): ("chunked", 128, 5),                # d > 160: two tiles
    (366_000, 100, 768): ("chunked", 6 * 256, 239),    # curation's level
    (151_962, 100, 18): ("rows", 3 * 256, 198),        # susy second level
    (1_460_000, 3, 34): ("centers", 22 * 256, 260),    # kdd4 second level
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_lloyd_plan(shape):
    n, k, d = shape
    plan = lloyd_plan(n, k, d)
    assert isinstance(plan, LloydPlan)
    assert (plan.route, plan.rows, plan.grid) == PLANS[shape]
    # whole tiles: of `threads` rows, of 128 on the chunked route
    assert plan.rows % (128 if plan.route == "chunked" else plan.threads) == 0
    assert plan.grid * plan.rows >= n
    assert n == 0 or (plan.grid - 1) * plan.rows < n
    assert plan.grid <= MAX_CTAS
    dp = padded_width(d)
    assert plan.threads == (256 if plan.route == "chunked"
                            else 128 if dp > 128 else 256)
    assert 0 <= plan.smem_bytes <= SMEM_MAX
    k1 = k * (d + 1)
    if plan.route == "chunked":
        # pdist_common.cuh's chunked tile, then the serial route's partial
        # (in shared memory up to 96 KB) over whole 128-row tiles
        assert d >= CHUNKED_FROM_D and plan.rows % 128 == 0
        assert plan.smem_bytes == CK_SMEM + (4 * k1 if k1 <= 24_576 else 0)
    elif plan.route != "serial":
        # lloyd.cu: two buffers of xs (NT x (DP + 4)) and ws (NT) | k
        # centers and norms | one (k, d + 1) partial per warp, per half-warp
        # above FEW_CENTERS
        assert dp > 0
        assert plan.route == ("centers" if k <= FEW_CENTERS else "rows")
        parts = plan.threads // 32 * (2 if plan.route == "rows" else 1)
        assert plan.smem_bytes == 4 * (
            2 * plan.threads * (dp + 5) + k * (dp + 1) + parts * k * (d + 1))
    else:
        # the per-CTA partial in shared memory up to 96 KB, else global;
        # plus RowScan's static tiles
        assert plan.smem_bytes == (4 * k1 if k1 <= 24_576 else 0)
        tm = 16 if dp > 128 else (32 if dp > 64 else 64)
        static = 4 * (tm * max(dp, 1) + tm + 2 * plan.threads)
        assert plan.smem_bytes + static <= SMEM_MAX


def test_lloyd_plan_opt_in():
    """A CTA of the warp route with small rows and few centers stays under
    the 48 KB a CTA gets without opting in; kdd's and gauss's pass it (the
    C entry opens the limit once per instantiation), and two of kdd's fit
    on one SM."""
    assert lloyd_plan(1000, 3, 5).smem_bytes <= STATIC_SMEM_MAX
    assert lloyd_plan(180_040, 100, 5).smem_bytes > STATIC_SMEM_MAX
    assert STATIC_SMEM_MAX < lloyd_plan(874_751, 3, 34).smem_bytes \
        <= SMEM_MAX // 2


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 874_751,
                               256 * MAX_CTAS, 256 * MAX_CTAS + 1,
                               3 * 256 * MAX_CTAS + 7])
@pytest.mark.parametrize("d", [5, 34, 130, 300])
def test_lloyd_split_depends_on_n_and_d_only(n, d):
    """The rows a CTA adds up, hence every partial's terms, follow from
    (n, d) alone: the same for any k and either route."""
    splits = {lloyd_plan(n, k, d)[1:4] for k in (1, 3, 100, 2048)}
    assert len(splits) == 1


@pytest.mark.parametrize("d", [161, 200, 256, 257, 768, 1024])
@pytest.mark.parametrize("k", [1, 3, 100, 2048])
def test_lloyd_plan_sends_past_160_to_the_chunked_assignment(d, k):
    n = 366_000
    plan = lloyd_plan(n, k, d)
    assert plan.route == "chunked"
    assert plan.threads == 256 and plan.rows % 128 == 0
    # the serial route's split of rows over CTAs, so its sums' terms
    assert plan[1:3] == lloyd_plan(n, k, d, "serial")[1:3]
    assert lloyd_plan(n, k, 160).route != "chunked"


@pytest.mark.parametrize("n, k, d", [(874_751, 3, 34), (180_040, 100, 5),
                                     (1025, 20, 130), (517, 65, 300)])
def test_lloyd_plan_named_route(n, k, d):
    """A named route keeps the split and is taken where its blocks fit,
    else raises; the serial route takes every shape."""
    routed = lloyd_plan(n, k, d)
    for route in ROUTES:
        try:
            plan = lloyd_plan(n, k, d, route)
        except ValueError as exc:
            assert route != "serial" and f"route {route!r}" in str(exc)
            assert routed.route != route
            continue
        assert plan.route == route
        assert plan[1:3] == routed[1:3]
        if "chunked" not in (route, routed.route):   # 256 threads always
            assert plan.threads == routed.threads
        assert plan.smem_bytes <= SMEM_MAX
    assert lloyd_plan(n, k, d, routed.route) == routed


# ------------------------------------------------------------ output views
@pytest.mark.parametrize("n, k, d", [(0, 3, 34), (1, 1, 5), (257, 3, 34),
                                     (1000, 37, 18)])
def test_split_outputs(n, k, d):
    buf = torch.empty((k * d + k + 2 * n,), dtype=torch.float32)
    sums, counts, assign, dist = split_outputs(buf, n, k, d)
    assert sums.shape == (k, d) and sums.dtype == torch.float32
    assert counts.shape == (k,) and counts.dtype == torch.float32
    assert assign.shape == (n,) and assign.dtype == torch.int32
    assert dist.shape == (n,) and dist.dtype == torch.float32
    # every word of the buffer belongs to exactly one view
    owner = torch.zeros(buf.numel(), dtype=torch.int64)
    base = buf.data_ptr()
    for i, v in enumerate((sums, counts, assign, dist)):
        assert v.untyped_storage().data_ptr() == buf.untyped_storage() \
            .data_ptr()
        start = (v.data_ptr() - base) // 4
        owner[start:start + v.numel()] += 1 << (8 * i)
    assert bool(((owner == 1) | (owner == 1 << 8) | (owner == 1 << 16)
                 | (owner == 1 << 24)).all())
    assert int(owner.sum()) == (k * d + (k << 8) + (n << 16) + (n << 24))


# ----------------------------------------------- CPU path vs the reference
@pytest.mark.parametrize("d", [5, 34, 130, 300])
@pytest.mark.parametrize("k", [1, 3, 100])
@pytest.mark.parametrize("metric", ["l2sq", "l2"])
def test_lloyd_cpu_matches_pallas(d, k, metric):
    n = 257
    rng = np.random.default_rng(d * 1000 + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0, 3, size=(n,)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    sk, ck, ak, dk = lloyd_step_pallas(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(c), metric=metric,
                                       interpret=True)
    xt, wt, ct = (torch.as_tensor(a) for a in (x, w, c))
    got = lloyd_step(xt, wt, ct, metric=metric)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(sk), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ck), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ak))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(dk), rtol=1e-5,
                               atol=1e-5)
    # the wrapper on a CPU tensor is the plain version
    for a, b in zip(lloyd_step_cuda(xt, wt, ct, metric=metric),
                    lloyd_step_blocked(xt, wt, ct, metric=metric)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ launch count
@pytest.mark.parametrize("n", [0, 1, 257])
def test_launch_count_only_where_kernels_launch(monkeypatch, n):
    """``lloyd_step_cuda.launches`` goes up once per call that reaches the
    C entry, and not for n = 0 (zeros, no launch).  Tensors on the meta
    device stand in for CUDA ones: the operand check and the C entry are
    stubbed, so everything else in the launch path runs as on the card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lloyd import kernel as lk
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(lk, "check_operands", lambda *a: None)
    monkeypatch.setattr(_build, "bind", lambda *a, **kw: entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda x: 0)
    k, d = 3, 34
    x = torch.empty((n, d), device="meta")
    w = torch.empty((n,), device="meta")
    c = torch.empty((k, d), device="meta")
    monkeypatch.setattr(lloyd_step_cuda, "launches", 0)
    sums, counts, assign, dist = lloyd_step_cuda(x, w, c)
    assert (sums.shape, counts.shape, assign.shape, dist.shape) == \
        ((k, d), (k,), (n,), (n,))
    assert lloyd_step_cuda.launches == len(calls) == (1 if n else 0)
    # a measurement's launch, by route or by plan, counts nowhere
    if n:
        lk._launch_route("centers", x, w, c)
        lk._launch_route(lloyd_plan(n, k, d, "serial"), x, w, c)
        assert lloyd_step_cuda.launches == 1 and len(calls) == 3
