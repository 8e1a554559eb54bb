"""The port's training path (``forward_train`` with remat, the WKV compute
dtype and inner remat under autograd, ``make_train_step``) against the
reference's, at the SMOKE config (2 layers, d = 64, f32), with the
reference's own weights carried across by ``params_from_numpy``.

Tolerances: both sides compute in f32 and sum in other orders (XLA's CPU
dots pairwise, torch's sequentially), so the loss is held to rtol 1e-5 and
each gradient leaf to 2e-5 of its largest magnitude (2e-6 is seen).  With
``wkv_compute_dtype="bfloat16"`` the WKV call itself agrees to 1e-6 of its
magnitude, forward and backward (a product of bf16 values is exact in f32,
and both frameworks round the same operands and cotangents); through the
whole model a cotangent an f32 ulp from a bf16 rounding boundary rounds to
the neighbouring bf16 value on one side, so there each gradient leaf is
held to one bf16 ulp (2^-8) of its largest magnitude.  Remat policies
change what a backward pass saves, not what it computes: bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import rwkv6 as jrw
from repro.models import transformer as jtf
from repro.models.layers import ShardCtx
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
from repro_torch.launch.steps import make_train_step
from repro_torch.models import rwkv6 as trw
from repro_torch.models.transformer import (ce_loss, forward_train,
                                            init_params, params_from_numpy,
                                            reference_key)
from repro_torch.optim import adamw

torch.set_num_threads(1)

CTX = ShardCtx(mesh=None)
ARCH = "rwkv6-7b"
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config(ARCH, smoke=True)
    jparams = jtf.init_params(cfg, jax.random.key(0))
    # a non-zero bonus u, so the bonus term takes part (init gives zeros)
    rng = np.random.default_rng(3)
    jparams["layers"]["tmix"]["u"] = jnp.asarray(
        rng.normal(size=jparams["layers"]["tmix"]["u"].shape) * 0.5,
        jnp.float32)
    toks = np.random.default_rng(42).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    return cfg, jparams, toks


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, name):
    key, index = reference_key(name)
    for part in key:
        tree = tree[part]
    a = np.asarray(jnp.asarray(tree).astype(jnp.float32))
    return a if index is None else a[index]


def _ref_loss_and_grads(cfg, jparams, toks):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jtf.forward_train(p, {"tokens": jnp.asarray(toks)}, cfg,
                                    CTX), has_aux=True)(jparams)
    return float(loss), metrics, grads


def _port_loss_and_grads(cfg, jparams, toks):
    model = params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    loss, metrics = forward_train(model, {"tokens": torch.as_tensor(toks)},
                                  cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss.detach()), metrics, dict(zip(names, grads))


def _assert_grads(grads, ref, tol):
    assert grads
    for name, g in grads.items():
        r = _leaf(ref, name)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - r).max()) / scale
        assert err <= tol, (name, err)


# ------------------------------------------------------------------ loss
def test_ce_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 9, 40)).astype(np.float32) * 4
    tokens = rng.integers(0, 40, (3, 9)).astype(np.int32)
    mask = rng.random((3, 9)) > 0.3
    want = float(jtf.ce_loss(jnp.asarray(logits), jnp.asarray(tokens),
                             jnp.asarray(mask)))
    got = ce_loss(torch.as_tensor(logits), torch.as_tensor(tokens),
                  torch.as_tensor(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # an all-masked batch divides by max(0, 1), as the reference does
    none = torch.zeros((3, 9), dtype=torch.bool)
    assert float(ce_loss(torch.as_tensor(logits), torch.as_tensor(tokens),
                         none)) == 0.0


# ---------------------------------------------------- forward + gradients
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_train_loss_and_grads_match_reference(smoke, use_kernel):
    """Loss, its parts and every gradient leaf on either WKV route (the
    reference runs its Pallas route as ``tests/test_models.py`` does on the
    CPU; the port's kernel wrapper runs its plain version on CPU tensors,
    and its backward is the step oracle's, as the reference's)."""
    cfg, jparams, toks = smoke
    cfg = cfg.replace(wkv_use_pallas=use_kernel)
    jl, jm, jg = _ref_loss_and_grads(cfg, jparams, toks)
    wkv_forward_cuda.launches = 0
    tl, tm, tg = _port_loss_and_grads(cfg, jparams, toks)
    assert wkv_forward_cuda.launches == 0     # CPU tensors launch nothing
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=LOSS_RTOL)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _assert_grads(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("policy", ["none", "nothing", "dots"])
def test_remat_policies(smoke, policy):
    """Each policy against the reference's same policy, and bit for bit
    the port without remat."""
    cfg, jparams, toks = smoke
    cfg_p = cfg.replace(remat_policy=policy)
    jl, _, jg = _ref_loss_and_grads(cfg_p, jparams, toks)
    tl, _, tg = _port_loss_and_grads(cfg_p, jparams, toks)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_grads(tg, jg, GRAD_TOL)
    bl, _, bg = _port_loss_and_grads(cfg.replace(remat_policy="none"),
                                     jparams, toks)
    assert tl == bl
    for name in bg:
        assert torch.equal(tg[name], bg[name]), name


def test_remat_policy_unknown_raises(smoke):
    cfg, jparams, toks = smoke
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(cfg.replace(remat_policy="everything"), jparams,
                             toks)


def test_wkv_inner_remat_matches_reference(smoke):
    """``wkv_inner_remat`` on the plain chunked route recomputes each chunk
    in the backward pass (the reference: ``jax.checkpoint`` of the scan
    body): against the reference's, and bit for bit the port without it."""
    cfg, jparams, toks = smoke
    cfg_r = cfg.replace(wkv_inner_remat=True, wkv_chunk=8)
    jl, _, jg = _ref_loss_and_grads(cfg_r, jparams, toks)
    tl, _, tg = _port_loss_and_grads(cfg_r, jparams, toks)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_grads(tg, jg, GRAD_TOL)
    bl, _, bg = _port_loss_and_grads(cfg_r.replace(wkv_inner_remat=False),
                                     jparams, toks)
    assert tl == bl
    for name in bg:
        assert torch.equal(tg[name], bg[name]), name


def _wkv_args(seed=0, Bx=2, T=32, H=2, K=8):
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(Bx, T, H, K)).astype(np.float32)
            for _ in range(3)]
    lw = (-np.exp(rng.uniform(-3, 1, size=(Bx, T, H, K)))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = rng.normal(size=(Bx, H, K, K)).astype(np.float32)
    ct = rng.normal(size=(Bx, T, H, K)).astype(np.float32)
    return args + [lw, u, s0], ct


@pytest.mark.parametrize("inner_remat", [False, True])
def test_wkv_bf16_compute_dtype_matches_reference(smoke, inner_remat):
    """``wkv_compute_dtype="bfloat16"``: the chunked WKV's outputs and its
    gradients against the reference's bf16 ``wkv_chunked`` (with and
    without inner remat), then the whole model's loss and gradients."""
    arrs, ct = _wkv_args()

    def ref(*a):
        o, s = jrw.wkv_chunked(*a, 16, inner_remat,
                               compute_dtype=jnp.bfloat16)
        return (o * ct).sum() + s.sum(), (o, s)

    (_, (jo, js)), jg = jax.value_and_grad(
        ref, argnums=tuple(range(6)), has_aux=True)(
            *[jnp.asarray(a) for a in arrs])
    tt = [torch.tensor(a, requires_grad=True) for a in arrs]
    to, ts = trw.wkv_chunked(*tt, 16, inner_remat,
                             compute_dtype=torch.bfloat16)
    tg = torch.autograd.grad((to * torch.as_tensor(ct)).sum() + ts.sum(), tt)
    for got, want in [(to, jo), (ts, js), *zip(tg, jg)]:
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), err
    # bf16 rounding moves the result: the f32 path is another number
    o32, _ = trw.wkv_chunked(*[torch.as_tensor(a) for a in arrs], 16)
    assert not torch.equal(o32, to.detach())

    cfg, jparams, toks = smoke
    cfg_b = cfg.replace(wkv_compute_dtype="bfloat16",
                        wkv_inner_remat=inner_remat)
    jl, _, jgr = _ref_loss_and_grads(cfg_b, jparams, toks)
    tl, _, tgr = _port_loss_and_grads(cfg_b, jparams, toks)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_grads(tgr, jgr, BF16_ULP)


# ------------------------------------------------------------ train step
def test_make_train_step_from_carried_state(smoke):
    """The reference runs two steps; its parameters and AdamW state are
    carried across (``params_from_numpy``, ``opt_state_from_numpy``) and
    each side takes step 3 on the same batch: metrics, parameters and
    moments.  (From step 2 on, Adam's update is no longer sign(g), so a
    gradient an ulp away moves it by an ulp, not by lr.)"""
    cfg, jparams, _ = smoke
    jstep, joptc = jax_make_train_step(cfg, mesh=None)
    jopt = jadamw.init(jparams, joptc)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
               for _ in range(3)]
    for b in batches[:2]:
        jparams, jopt, _ = jstep(jparams, jopt, {"tokens": jnp.asarray(b)})
    model = params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    step, optc = make_train_step(cfg, device="cpu")
    assert optc == adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    opt = adamw.opt_state_from_numpy(_np_tree(jopt), cfg, device="cpu")
    jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(
        batches[2])})
    model, opt, m = step(model, opt, {"tokens": batches[2]})
    assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for k in m:
        assert m[k].dim() == 0 and not m[k].requires_grad
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
    assert int(opt.step) == int(jopt.step) == 3
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(jparams, name),
                                   rtol=1e-5, atol=1e-7)
        for mom, jmom in ((opt.m, jopt.m), (opt.v, jopt.v)):
            want = _leaf(jmom, name)
            np.testing.assert_allclose(
                mom[name].numpy(), want, rtol=0,
                atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """``tests/test_models.py``'s smoke test for the port: every
    architecture (rwkv6, dense, moe, rglru_hybrid, encdec) takes one full
    train step (fwd + bwd + AdamW) on the CPU, with finite metrics, shapes
    kept and parameters changed, on the reference's batch (patches for a
    vlm arch; for encdec, 64 tokens and max(64 // 4, 8) frames)."""
    cfg = get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config(arch, smoke=True))
    model = init_params(cfg, 0, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step, optc = make_train_step(cfg, mesh=None, device="cpu")
    opt = adamw.init(model, optc)
    rng = np.random.default_rng(0)
    S = 64
    n_text = S if cfg.family == "encdec" else S - cfg.frontend_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, n_text))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, max(S // 4, 8),
                                           cfg.frontend_dim)).astype(
            np.float32)
    elif cfg.frontend == "vlm_patches":
        batch["patches"] = rng.normal(size=(2, cfg.frontend_tokens,
                                            cfg.frontend_dim)).astype(
            np.float32)
    model, new_opt, metrics = step(model, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")
    changed = []
    for n, p in model.named_parameters():
        assert p.shape == before[n].shape
        changed.append(not torch.equal(p, before[n]))
    assert any(changed)
    assert int(new_opt.step) == 1
