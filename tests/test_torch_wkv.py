"""The port's WKV6 (plain chunked version, step oracle and the autograd
Function) against the reference: ``wkv_forward_pallas`` in interpret mode
and the jnp ``wkv_ref``, on the same numpy inputs.

Shapes and tolerances are ``tests/test_kernels.py``'s: f32 within atol
1e-3, gradients within rtol/atol 1e-3.  The CUDA kernel itself is held to
the plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.wkv.kernel import wkv_forward_pallas
from repro.kernels.wkv.ops import wkv_forward as jax_wkv_forward
from repro.kernels.wkv.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.wkv.kernel import wkv_forward_cuda, wkv_forward_plain
from repro_torch.kernels.wkv.ops import wkv_forward
from repro_torch.kernels.wkv.ref import wkv_ref

torch.set_num_threads(1)

SHAPES = [(8, 64, 64, 16), (16, 32, 64, 16), (8, 128, 64, 64)]


def _inputs(BH, T, K, seed, per_row_u=False, decay=(-6, 3)):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, T, K)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.uniform(*decay, size=(BH, T, K)))).astype(np.float32)
    u = rng.normal(size=(BH, K) if per_row_u else (K,)).astype(np.float32)
    s0 = rng.normal(size=(BH, K, K)).astype(np.float32)
    return r, k, v, lw, u, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("per_row_u", [False, True], ids=["u_K", "u_BHxK"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_plain_and_oracle_match_pallas(shape, per_row_u):
    BH, T, K, c = shape
    arrs = _inputs(BH, T, K, BH + T, per_row_u)
    ok, sk = wkv_forward_pallas(*_j(arrs), chunk=c, interpret=True)
    orf, srf = jax_wkv_ref(*_j(arrs))
    for o, s in (wkv_forward_plain(*_t(arrs), chunk=c),
                 wkv_forward_cuda(*_t(arrs), chunk=c),
                 wkv_ref(*_t(arrs))):
        assert o.dtype == torch.float32 and s.dtype == torch.float32
        for want_o, want_s in ((ok, sk), (orf, srf)):
            np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                                       atol=1e-3)
            np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                       atol=1e-3)


def test_wkv_chunk_longer_than_sequence():
    """T < chunk: c = T (here 7, not a power of two)."""
    arrs = _inputs(8, 7, 16, 3)
    ok, sk = wkv_forward_pallas(*_j(arrs), chunk=16, interpret=True)
    o, s = wkv_forward_plain(*_t(arrs), chunk=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(ok), atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), atol=1e-3)


def test_wkv_bf16_inputs_match_pallas():
    """bf16 r, k, v (f32 lw, u, s0), as the FULL config hands them: both
    sides upcast the same bf16 values, accumulate in f32 and round o to
    bf16, so they differ by at most a bf16 rounding of o (2^-8 relative)."""
    BH, T, K, c = 8, 64, 64, 16
    r, k, v, lw, u, s0 = _inputs(BH, T, K, 11)
    rkv_j = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    rkv_t = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
             for a in rkv_j]
    ok, sk = wkv_forward_pallas(*rkv_j, *_j((lw, u, s0)), chunk=c,
                                interpret=True)
    o, s = wkv_forward_plain(*rkv_t, *_t((lw, u, s0)), chunk=c)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    want = np.asarray(ok.astype(jnp.float32))
    np.testing.assert_allclose(o.float().numpy(), want,
                               atol=1e-3, rtol=2 ** -7)
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), atol=1e-3)


def test_wkv_rejects_v_not_k_and_ragged_chunks():
    r, k, v, lw, u, s0 = _t(_inputs(8, 24, 16, 4))
    with pytest.raises(ValueError, match="V = 8 != K = 16"):
        wkv_forward_cuda(r, k, v, lw, u, s0[:, :, :8].contiguous())
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        wkv_forward_cuda(r, k, v, lw, u, s0, chunk=16)
    with pytest.raises(ValueError, match="u must be"):
        wkv_forward_plain(r, k, v, lw, u[:5], s0, chunk=8)


def test_wkv_cpu_tensor_runs_plain_version_and_counts_no_launch():
    arrs = _t(_inputs(8, 32, 16, 5))
    before = wkv_forward_cuda.launches
    o1, s1 = wkv_forward_cuda(*arrs, chunk=16)
    o2, s2 = wkv_forward_plain(*arrs, chunk=16)
    assert wkv_forward_cuda.launches == before
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


def test_wkv_function_grads_match_jax():
    """``tests/test_kernels.py``'s custom-VJP case, for every input: the
    port's autograd Function (kernel forward, oracle recompute backward)
    against ``jax.grad`` of the reference's ``wkv_forward``."""
    BH, T, K = 4, 32, 16
    rng = np.random.default_rng(5)
    r, k, v = (rng.normal(size=(BH, T, K)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.uniform(-4, 1, size=(BH, T, K)))).astype(np.float32)
    u = rng.normal(size=(K,)).astype(np.float32)
    s0 = rng.normal(size=(BH, K, K)).astype(np.float32)
    arrs = (r, k, v, lw, u, s0)

    def loss_jax(*a):
        o, sT = jax_wkv_forward(*a, 16)
        return (o ** 2).sum() + (sT * 0.5).sum()

    want = jax.grad(loss_jax, argnums=tuple(range(6)))(*_j(arrs))
    ts = [t.requires_grad_(True) for t in _t(arrs)]
    o, sT = wkv_forward(*ts, 16)
    ((o ** 2).sum() + (sT * 0.5).sum()).backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-3, atol=1e-3)
