"""The serving score's CPU-visible launch path (``kernels/score/kernel.py``,
``kernels/dispatch.py``): the CUDA kernel's launch shape, the memo of
registry resolutions, the threshold check that guards the kernel, and the
CPU path of ``score`` against the reference's ``score_pallas`` in interpret
mode.  The kernel itself runs only on the card (``chip_smoke.py`` holds it
to ``min_argmin_cuda`` plus the divide bit for bit at these edges).

Tolerances are ``tests/test_torch_kernels_fused.py``'s: distances and
scores rtol/atol 1e-5 against the reference, argmins equal, and the fused
CPU path equal to the composed min_argmin + divide bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.score.kernel import score_pallas
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.kernels.score.kernel import (SMS, check_threshold,
                                              launch_plan, padded_width,
                                              score_cuda)
from repro_torch.kernels.score.ops import score, score_blocked

torch.set_num_threads(1)

STATIC_SMEM_MAX = 48 * 1024    # bytes a CTA gets without opting in
DYNAMIC_SMEM_MAX = 232_448     # bytes a CTA may opt in to on sm_90


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("n, d, rows, grid", [
    (0, 34, 32, 0),
    (1, 34, 32, 1),
    (32, 34, 32, 1),
    (256, 34, 32, 8),            # the kdd serving micro-batch: 8 SMs
    (256, 5, 32, 8),             # the gauss one
    (4_224, 34, 32, 132),        # 132 x 32: one 32-row CTA per SM
    (4_225, 34, 64, 67),
    (33_793, 34, 256, 133),
    (10**6, 34, 256, 3_907),     # bulk: 256-row CTAs as before
    (10**6, 130, 128, 7_813),    # past d = 128: 128-row CTAs
    (10**6, 300, 256, 3_907),    # generic width: RowScan's loads
])
def test_launch_plan(n, d, rows, grid):
    plan = launch_plan(n, d)
    assert (plan.rows, plan.grid) == (rows, grid)
    assert plan.rows % 32 == 0 and plan.grid * plan.rows >= n
    assert n == 0 or (plan.grid - 1) * plan.rows < n
    dp = padded_width(d)
    if dp == 0:
        assert plan.smem_bytes == 0
        return
    # x's rows at pitch DP + 4 (P / 4 odd), reused for TM centers + norms
    assert (dp + 4) % 4 == 0 and ((dp + 4) // 4) % 2 == 1
    tm = 64 if dp <= 64 else (32 if dp <= 128 else 16)
    assert plan.smem_bytes >= 4 * plan.rows * (dp + 4)
    assert plan.smem_bytes >= 4 * tm * (dp + 1)
    assert plan.smem_bytes <= (STATIC_SMEM_MAX if dp <= 40
                               else DYNAMIC_SMEM_MAX)


@pytest.mark.parametrize("d", [1, 5, 34, 64, 128, 130, 256])
def test_launch_plan_rows_never_shrink_with_n(d):
    """Rows per CTA grow with n up to NT, and the CTAs fill the SMs once
    there are enough rows."""
    last = 0
    for n in range(1, 70_000, 997):
        plan = launch_plan(n, d)
        assert plan.rows >= last
        last = plan.rows
        if n >= SMS * plan.rows:
            assert plan.grid >= SMS


# -------------------------------------------------------- resolution memo
_CALL = dict(metric="l2sq", n=256, m=3, d=34, dtype=torch.float32)


@pytest.mark.parametrize("platform, policy", [
    ("cuda", None), ("cpu", None), ("cuda", KernelPolicy(backend="ref")),
    ("cpu", KernelPolicy(backend="int8", block_n=64)),
])
def test_memo_gives_a_fresh_resolution(platform, policy):
    dispatch._memo.clear()
    first = dispatch.resolve_tiles("score", policy, platform=platform,
                                   **_CALL)
    assert dispatch._memo                       # remembered
    again = dispatch.resolve_tiles("score", policy, platform=platform,
                                   **_CALL)
    assert again == first
    reg = dispatch.select_backend("score", policy, platform=platform,
                                  **_CALL)
    bn = (policy.block_n if policy is not None and policy.block_n
          else reg.default_block_n(platform))
    assert first == (reg, bn, reg.default_block_m(platform))
    assert dispatch.resolve("score", policy, platform=platform,
                            **_CALL) == first[:2]


def test_register_clears_the_memo():
    dispatch.resolve_tiles("score", None, platform="cpu", **_CALL)
    probe = lambda *a, **k: None                  # noqa: E731
    try:
        dispatch.register("score", "probe",
                          supports=lambda *a: True,
                          priority=lambda platform: 99,
                          default_block_n=lambda platform: 8,
                          default_block_m=lambda platform: 8)(probe)
        reg, bn, bm = dispatch.resolve_tiles("score", None, platform="cpu",
                                             **_CALL)
        assert (reg.name, bn, bm) == ("probe", 8, 8)
    finally:
        del dispatch._REGISTRY["score"]["probe"]
        dispatch._memo.clear()
    reg, _, _ = dispatch.resolve_tiles("score", None, platform="cpu", **_CALL)
    assert reg.name == "blocked"


def test_default_policy_is_part_of_the_key():
    reg, _, _ = dispatch.resolve_tiles("score", None, platform="cuda",
                                       **_CALL)
    assert reg.name == "cuda"
    with dispatch.using_policy(KernelPolicy(backend="blocked")):
        reg, _, _ = dispatch.resolve_tiles("score", None, platform="cuda",
                                           **_CALL)
        assert reg.name == "blocked"
    reg, _, _ = dispatch.resolve_tiles("score", None, platform="cuda",
                                       **_CALL)
    assert reg.name == "cuda"


def test_memo_stays_bounded():
    dispatch._memo.clear()
    for n in range(dispatch._MEMO_MAX + 10):
        dispatch.resolve("min_argmin", None, metric="l2sq", n=n, m=3, d=5,
                         platform="cpu")
    assert 0 < len(dispatch._memo) <= dispatch._MEMO_MAX


# ------------------------------------------------------- threshold check
@pytest.mark.parametrize("thr", [
    0.5,
    np.float32(0.5),
    torch.tensor(0.5, dtype=torch.float64),
    torch.tensor([0.5, 0.6]),
    torch.tensor([], dtype=torch.float32),
    torch.tensor(0.5, device="meta"),
])
def test_threshold_check_raises(thr):
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="score_cuda: threshold must be a "
                       "one-element float32 tensor on cpu"):
        check_threshold(thr, x)


@pytest.mark.parametrize("thr", [torch.tensor(0.5), torch.tensor([0.5]),
                                 torch.tensor([[0.5]])])
def test_threshold_check_passes(thr):
    check_threshold(thr, torch.zeros((4, 3)))


# ----------------------------------------------- CPU path vs the reference
@pytest.mark.parametrize("n", [1, 33, 256, 257])
@pytest.mark.parametrize("k, d", [(3, 34), (100, 5)])
@pytest.mark.parametrize("metric", ["l2sq", "l2", "l1"])
def test_score_cpu_matches_pallas_and_composed(n, k, d, metric):
    rng = np.random.default_rng(n * 7 + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    dk, ak, sk = score_pallas(jnp.asarray(x), jnp.asarray(c),
                              jnp.float32(0.9), metric=metric,
                              interpret=True)
    xt, ct, thr = torch.as_tensor(x), torch.as_tensor(c), torch.tensor(0.9)
    dist, idx, sc = score(xt, ct, thr, metric=metric)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ak))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sk), rtol=1e-5,
                               atol=1e-5)
    d2, a2 = min_argmin(xt, ct, metric=metric)
    assert torch.equal(dist, d2) and torch.equal(idx, a2)
    assert torch.equal(sc, d2 / torch.clamp(thr, min=1e-30))
    # the wrapper on a CPU tensor is the plain version
    for got, want in zip(score_cuda(xt, ct, thr, metric=metric),
                         score_blocked(xt, ct, thr, metric=metric)):
        assert torch.equal(got, want)
