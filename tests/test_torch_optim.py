"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw``, from seeded numpy inputs, on the SMOKE rwkv6 model's
parameters where a model's names matter.

Tolerances: on identical parameters, gradients and state both sides run
the same f32 arithmetic op for op; the global norm sums its leaves in
another order (the port per layer, the reference per stacked leaf) and XLA
and torch evaluate pow, cos and sqrt within an ulp of each other, so f32
results are held to rtol 1e-5 (a few ulps after three steps).  A value
stored in bf16 (moments under ``state_dtype="bfloat16"``, bf16 parameters)
is held to one bf16 ulp (2^-8 relative): an f32 value an ulp away from a
rounding boundary rounds to the neighbouring bf16 value.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.models.transformer import (params_from_numpy, params_tree,
                                            reference_key)
from repro_torch.optim import adamw

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_REL = 2.0 ** -8


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _jnp_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaf(tree, name):
    key, index = reference_key(name)
    for part in key:
        tree = tree[part]
    a = _jnp_np(tree)
    return a if index is None else a[index]


# ------------------------------------------------- the reference's own tests
def test_adamw_converges_quadratic():
    target = torch.as_tensor(np.random.default_rng(0).normal(size=(32,)),
                             dtype=torch.float32)
    params = {"w": torch.zeros((32,))}
    c = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=10, total_steps=300,
                          weight_decay=0.0)
    st = adamw.init(params, c)
    for _ in range(300):
        g = {"w": params["w"] - target}
        params, st, m = adamw.apply(params, g, st, c)
    assert float((params["w"] - target).abs().max()) < 0.05
    assert int(st.step) == 300


def test_adamw_bf16_state_close_to_f32():
    rng = np.random.default_rng(1)
    w0 = torch.as_tensor(rng.normal(size=(64,)), dtype=torch.float32)
    g = {"w": torch.as_tensor(rng.normal(size=(64,)) * 0.1,
                              dtype=torch.float32)}
    out = {}
    for dt in ("float32", "bfloat16"):
        c = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, state_dtype=dt)
        p = {"w": w0.clone()}
        st = adamw.init(p, c)
        assert st.m["w"].dtype == getattr(torch, dt)
        for _ in range(20):
            p, st, _ = adamw.apply(p, g, st, c)
        out[dt] = p["w"].numpy()
    np.testing.assert_allclose(out["bfloat16"], out["float32"],
                               rtol=0.02, atol=1e-4)


def test_grad_clip():
    g = {"w": torch.full((100,), 10.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    assert float(norm) == pytest.approx(100.0)


# ------------------------------------------------ against the reference
def _smoke(dtype="float32"):
    cfg = get_config("rwkv6-7b", smoke=True).replace(dtype=dtype)
    jparams = jtf.init_params(cfg, jax.random.key(0))
    return cfg, jparams


def _grads_like(jparams, rng, scale):
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * scale, p.dtype),
        jparams)


def _assert_close(port, ref, bf16):
    if bf16:
        np.testing.assert_allclose(port, ref, rtol=BF16_REL,
                                   atol=BF16_REL * np.abs(ref).max() * 1e-3)
    else:
        np.testing.assert_allclose(port, ref, **F32_TOL)


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_apply_matches_reference_over_three_steps(param_dtype, state_dtype):
    """Three steps from identical parameters, gradients and state (fresh
    gradients each step, one of them clipped): parameters, moments and the
    metrics after each."""
    cfg, jparams = _smoke(param_dtype)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    params = dict(model.named_parameters())
    c = adamw.AdamWConfig(warmup_steps=2, total_steps=10,
                          state_dtype=state_dtype)
    jc = jadamw.AdamWConfig(warmup_steps=2, total_steps=10,
                            state_dtype=state_dtype)
    st, jst = adamw.init(params, c), jadamw.init(jparams, jc)
    rng = np.random.default_rng(5)
    for step, scale in enumerate((1e-3, 1.0, 1e-2)):   # 1.0: clipped
        jg = _grads_like(jparams, rng, scale)
        g = {n: t.detach() for n, t in params_from_numpy(
            jax.tree.map(np.asarray, jg), cfg, device="cpu").named_parameters()}
        jparams, jst, jm = jadamw.apply(jparams, jg, jst, jc)
        _, st, m = adamw.apply(params, g, st, c)
        assert int(st.step) == int(jst.step) == step + 1
        for k in ("grad_norm", "lr"):
            assert m[k].dim() == 0
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        for name, p in params.items():
            _assert_close(_np(p), _leaf(jparams, name),
                          param_dtype == "bfloat16")
            assert st.m[name].dtype == getattr(torch, state_dtype)
            for mom, jmom in ((st.m, jst.m), (st.v, jst.v)):
                _assert_close(_np(mom[name]), _leaf(jmom, name),
                              state_dtype == "bfloat16")


@pytest.mark.parametrize("step", [0, 1, 99, 200, 5_000, 10_000, 12_000])
def test_lr_schedule_matches_reference(step):
    """At 0, in warm-up, at its end, in the cosine, at the end of the
    schedule and past it."""
    c = adamw.AdamWConfig()
    got = adamw.lr_schedule(c, torch.tensor(step, dtype=torch.int32))
    want = jadamw.lr_schedule(jadamw.AdamWConfig(), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_decay_mask_leaf_by_leaf():
    """The port's mask on each parameter name equals the reference's on
    the leaf that name maps to, for every leaf of the rwkv6 tree."""
    cfg, jparams = _smoke()
    want = {"/".join(str(k.key) for k in path): jadamw._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    got = {}
    for name, _ in model.named_parameters():
        got.setdefault(adamw.reference_path(name), set()).add(
            adamw._decay_mask(name))
    assert set(got) == set(want)
    for path, flags in got.items():
        assert flags == {want[path]}, path
    # the substrings are the reference's: "u" and "mu" exempt those leaves
    assert not want["layers/tmix/u"] and not want["layers/tmix/mu"]
    assert want["layers/tmix/wr"] and want["embed/table"]


def test_opt_state_from_numpy():
    """The reference's state after two steps, carried across: every moment
    leaf bit for bit, the step, and ``opt_state_tree`` giving the
    reference's layout back."""
    cfg, jparams = _smoke()
    jc = jadamw.AdamWConfig()
    jst = jadamw.init(jparams, jc)
    rng = np.random.default_rng(6)
    for _ in range(2):
        jparams, jst, _ = jadamw.apply(jparams, _grads_like(jparams, rng, 0.1),
                                       jst, jc)
    st = adamw.opt_state_from_numpy(jax.tree.map(np.asarray, jst), cfg,
                                    device="cpu")
    assert int(st.step) == 2 and st.step.dtype == torch.int32
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    assert set(st.m) == set(st.v) == {n for n, _ in model.named_parameters()}
    for name in st.m:
        np.testing.assert_array_equal(_np(st.m[name]), _leaf(jst.m, name))
        np.testing.assert_array_equal(_np(st.v[name]), _leaf(jst.v, name))
    back = adamw.opt_state_tree(st)
    for mine, ref in ((back.m, jst.m), (back.v, jst.v)):
        leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in leaves:
            node = mine
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    # and the parameters' tree is the reference's init_params layout
    tree = params_tree(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
