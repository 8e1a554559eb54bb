"""The port's kernel ops (plain torch versions, on the CPU) against the
reference: the Pallas kernels in interpret mode and the jnp oracles.

Same sweep and tolerances as ``tests/test_kernels.py``: f32 within
rtol/atol 1e-5, bf16 within 5e-2 (both sides upcast bf16 to f32 before any
arithmetic), argmins equal.  The CUDA kernels themselves are held to these
plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.pdist.kernel import min_argmin_pallas
from repro.kernels.pdist.ref import min_argmin_ref as jax_min_argmin_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
from repro_torch.kernels.pdist.kernel import min_argmin_cuda
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.kernels.pdist.ref import min_argmin_ref
from repro_torch.kernels.score.kernel import score_cuda
from repro_torch.kernels.score.ops import score

torch.set_num_threads(1)

SHAPES = [(64, 3, 5), (513, 128, 34), (1000, 37, 18), (1025, 200, 130)]
METRICS = ["l2sq", "l2", "l1"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BLOCKED = KernelPolicy(backend="blocked")


def _pair(shape, jdt, tdt, seed):
    n, m, d = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(m, d)).astype(np.float32)
    xj, cj = jnp.asarray(x, jdt), jnp.asarray(c, jdt)
    # identical (rounded) inputs on both sides
    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).to(tdt)
    ct = torch.as_tensor(np.array(cj.astype(jnp.float32))).to(tdt)
    return xj, cj, xt, ct


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pdist_matches_pallas_and_oracle(shape, metric, dtype):
    jdt, tdt = DTYPES[dtype]
    xj, cj, xt, ct = _pair(shape, jdt, tdt, sum(shape))
    dk, ak = min_argmin_pallas(xj, cj, metric=metric, interpret=True)
    dr, ar = jax_min_argmin_ref(xj.astype(jnp.float32),
                                cj.astype(jnp.float32), metric)
    tol = 1e-5 if dtype == "f32" else 5e-2
    for policy in (None, BLOCKED, KernelPolicy(backend="ref")):
        dp, ap = min_argmin(xt, ct, metric=metric, policy=policy)
        assert dp.dtype == torch.float32 and ap.dtype == torch.int32
        for want_d, want_a in ((dk, ak), (dr, ar)):
            np.testing.assert_allclose(dp.numpy(), np.asarray(want_d),
                                       rtol=tol, atol=tol)
            np.testing.assert_array_equal(ap.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("metric", METRICS)
def test_pdist_tie_breaks_to_first_index(metric):
    # duplicate centers: argmin must pick index 0, like the oracle
    x = torch.zeros((8, 4))
    c = torch.ones((133, 4))
    for policy in (None, BLOCKED, KernelPolicy(backend="ref")):
        _, a = min_argmin(x, c, metric=metric, policy=policy)
        assert (a == 0).all()
    _, a = score(x, c, torch.tensor(1.0), metric=metric,
                 policy=KernelPolicy(backend="blocked"))[:2]
    assert (a == 0).all()


@pytest.mark.parametrize("metric", ["l2sq", "l2"])
def test_far_center_rows_never_win(metric):
    # Alg. 2 marks invalid center slots with rows at 1e30: their squared norm
    # overflows to +inf, so they must come out +inf and never be selected
    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, 34)).astype(np.float32)
    c = np.concatenate([rng.normal(size=(5, 34)),
                        np.full((7, 34), 1e30)]).astype(np.float32)
    c = c[rng.permutation(12)]
    dr, ar = jax_min_argmin_ref(jnp.asarray(x), jnp.asarray(c), metric)
    d, a = min_argmin(torch.as_tensor(x), torch.as_tensor(c), metric=metric)
    assert torch.isfinite(d).all()
    assert (c[a.numpy(), 0] < 1e29).all()
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), rtol=1e-5,
                               atol=1e-5)


def test_dispatch_picks_cuda_on_card_and_blocked_on_cpu():
    for op in ("min_argmin", "lloyd_step", "score"):
        assert dispatch.select_backend(op, metric="l2sq", n=10, m=3, d=4,
                                       platform="cuda").name == "cuda"
        assert dispatch.select_backend(op, metric="l2sq", n=10, m=3, d=4,
                                       platform="cpu").name == "blocked"
        # cosine has no kernel, on either platform
        assert dispatch.select_backend(op, metric="cosine", n=10, m=3, d=4,
                                       platform="cuda").name == "blocked"
    # Lloyd's kernel is l2sq / l2; l1 assigns through min_argmin
    assert dispatch.select_backend("lloyd_step", metric="l1", n=10, m=3, d=4,
                                   platform="cuda").name == "blocked"
    # the tile autotuner is ported (tests/test_torch_dispatch.py)
    assert KernelPolicy(autotune=True).autotune
    with pytest.raises(ValueError):
        KernelPolicy(backend="pallas")


def test_wrappers_run_plain_on_cpu_and_count_only_launches():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(50, 5)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(4, 5)).astype(np.float32))
    w = torch.ones((50,))
    before = (min_argmin_cuda.launches, lloyd_step_cuda.launches,
              score_cuda.launches)
    d, a = min_argmin_cuda(x, c, metric="l2")
    dr, ar = min_argmin_ref(x, c, "l2")
    assert torch.equal(a, ar)
    torch.testing.assert_close(d, dr)
    assert torch.equal(lloyd_step_cuda(x, w, c)[2], ar)
    assert torch.equal(score_cuda(x, c, torch.tensor(2.0))[1], ar)
    # explicit backend="cuda" on a CPU tensor is the plain version too
    d2, a2 = min_argmin(x, c, metric="l2",
                        policy=KernelPolicy(backend="cuda"))
    assert torch.equal(a2, ar)
    assert (min_argmin_cuda.launches, lloyd_step_cuda.launches,
            score_cuda.launches) == before
