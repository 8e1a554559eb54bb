"""The port's fused ops (Lloyd step, serving score, int8 score), plain
torch versions on the CPU, against the reference's Pallas kernels in
interpret mode and its jnp oracles (the pdist sweep is in
``test_torch_kernels.py``).  Tolerances are the reference's own: Lloyd sums
rtol/atol 1e-4, everything else 1e-5, argmins equal; the fused score equals
the composed min_argmin + divide bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lloyd.kernel import lloyd_step_pallas
from repro.kernels.lloyd.ref import lloyd_step_ref as jax_lloyd_ref
from repro.kernels.score.kernel import score_pallas
from repro.kernels.score.ops import score_int8 as jax_score_int8
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.lloyd.ops import (accumulate_by_assignment,
                                           lloyd_step)
from repro_torch.kernels.lloyd.ref import lloyd_step_ref
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.kernels.score.ops import score

torch.set_num_threads(1)


def _pair(shape, seed):
    n, m, d = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(m, d)).astype(np.float32)
    return (jnp.asarray(x), jnp.asarray(c), torch.as_tensor(x),
            torch.as_tensor(c))

@pytest.mark.parametrize("shape", [(64, 3, 5), (513, 100, 34),
                                   (1025, 130, 200)])
@pytest.mark.parametrize("metric", ["l2sq", "l2"])
def test_lloyd_matches_pallas_and_oracle(shape, metric):
    n, k, d = shape
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0, 3, size=(n,)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    want = [lloyd_step_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c),
                              metric=metric, interpret=True),
            jax_lloyd_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c),
                          metric)]
    xt, wt, ct = (torch.as_tensor(a) for a in (x, w, c))
    for got in (lloyd_step(xt, wt, ct, metric=metric),
                lloyd_step_ref(xt, wt, ct, metric)):
        for sk, ck, ak, dk in want:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(sk),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ck),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(ak))
            np.testing.assert_allclose(got[3].numpy(), np.asarray(dk),
                                       rtol=1e-5, atol=1e-5)


def test_lloyd_weight_conservation():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(777, 12)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0, 1, size=(777,)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(13, 12)).astype(np.float32))
    for metric in ("l2sq", "l2", "l1"):
        _, counts, a, _ = lloyd_step(x, w, c, metric=metric)
        np.testing.assert_allclose(float(counts.sum()), float(w.sum()),
                                   rtol=1e-5)
        sums, cnt2 = accumulate_by_assignment(x, w, a, 13)
        np.testing.assert_allclose(sums.sum(0).numpy(),
                                   (x * w[:, None]).sum(0).numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2sq", "l2", "l1", "cosine"])
@pytest.mark.parametrize("m", [3, 300])
def test_fused_score_bit_identical_to_composed(metric, m):
    """Fused score == min_argmin + divide, bitwise, for the non-int8
    backends (``tests/test_serving.py``'s rule for the reference)."""
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(size=(300, 6)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(m, 6)).astype(np.float32))
    thr = torch.tensor(0.37, dtype=torch.float32)
    for backend in ("auto", "blocked", "ref"):
        pol = KernelPolicy(backend=backend)
        dist, amin, sc = score(x, c, thr, metric=metric, policy=pol)
        d2, a2 = min_argmin(x, c, metric=metric, policy=pol)
        assert torch.equal(dist, d2) and torch.equal(amin, a2)
        assert torch.equal(sc, d2 / torch.clamp(thr, min=1e-30))


@pytest.mark.parametrize("metric", ["l2sq", "l2", "l1"])
def test_score_matches_pallas(metric):
    xj, cj, xt, ct = _pair((257, 40, 9), 4)
    dk, ak, sk = score_pallas(xj, cj, jnp.float32(0.8), metric=metric,
                              interpret=True)
    d, a, s = score(xt, ct, torch.tensor(0.8), metric=metric)
    np.testing.assert_allclose(d.numpy(), np.asarray(dk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ak))
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-5,
                               atol=1e-5)


# (metric, x dtype, c dtype, seed): seed None is the original input,
# 300 x 20 x 7 normal rows and centers from seed 9, threshold 1.3, in f32;
# the others ROADMAP's, 512 x 34 normal rows, 16 centers 3 x normal,
# threshold 2.0, with bf16 centers and bf16 x beside f32
INT8_CASES = [pytest.param(m, "float32", "float32", None, id=m)
              for m in ("l2sq", "l2", "l1")] + [
    pytest.param(m, xd, cd, seed, id=f"{m}-x_{xd}-c_{cd}-seed{seed}")
    for m in ("l2sq", "l2", "l1")
    for xd, cd in (("float32", "float32"), ("float32", "bfloat16"),
                   ("bfloat16", "bfloat16"))
    for seed in (0, 1, 2)]


@pytest.mark.parametrize("metric, x_dtype, c_dtype, seed", INT8_CASES)
def test_int8_matches_jax_score_int8(metric, x_dtype, c_dtype, seed):
    """bf16 centers quantize on bf16's grid, with a saturating cast, as in
    the reference.  Tolerances: with f32 x the gap is summation order
    (<= 7.6e-5 on distances up to ~250, so rtol 1e-5); with bf16 x the
    reference does its distance arithmetic on bf16 x where the port
    upcasts x first (``kernels/pdist/ref.py``), a gap of at most 1.4e-3
    of the distance measured here, inside one bf16 rounding (2**-8)."""
    if seed is None:
        x, c, _, _ = _pair((300, 20, 7), 9)
        thr = 1.3
    else:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(512, 34)).astype(np.float32)
        c = (3 * rng.normal(size=(16, 34))).astype(np.float32)
        thr = 2.0
    x, c = np.array(x), np.array(c)
    dj, aj, sj = jax_score_int8(jnp.asarray(x).astype(x_dtype),
                                jnp.asarray(c).astype(c_dtype),
                                jnp.float32(thr), metric=metric)
    d, a, s = score(torch.as_tensor(x).to(getattr(torch, x_dtype)),
                    torch.as_tensor(c).to(getattr(torch, c_dtype)),
                    torch.tensor(thr), metric=metric,
                    policy=KernelPolicy(backend="int8"))
    tol = 1e-5 if x_dtype == "float32" else 2.0**-8
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj, dtype=np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj, dtype=np.float32),
                               rtol=tol, atol=tol)
    # opt-in only: auto never picks the quantized backend
    reg, _, _ = dispatch.resolve_tiles("score", None, metric=metric, n=300,
                                       m=20, d=7, platform="cuda")
    assert reg.name == "cuda"
