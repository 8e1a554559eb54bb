"""The port's token-choice MoE (``models/moe.py``) and moe family
(``models/transformer.py``'s moe prefill, decode and training) against the
reference, at SMOKE widths (qwen3-moe: 8 experts, top-2; llama4-maverick:
top-1, a shared expert, a dense layer before each MoE layer, patches),
with the reference's own weights carried across by
``params_from_numpy``.

Tolerances, as ``tests/test_torch_dense.py``: f32 outputs within 1e-5 of
their magnitude, the aux loss within 1e-6, gradient leaves within 2e-5 of
their largest magnitude.  Routing is compared exactly: the top-k ids, the
drop fraction and the set of tokens that lost an expert at capacity are
equal (a dropped expert moves its token's output by its weight times the
expert's output, far beyond 1e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.layers import ShardCtx
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import (forward_train, init_cache,
                                            params_tree)

from test_torch_dense import (F32_TOL, batch_for, check_train_against_reference,
                              close, jbatch, load_module, model_for,
                              ref_decode, ref_prefill, teacher_forcing)

torch.set_num_threads(1)

CTX = ShardCtx(mesh=None)
ARCH = "qwen3-moe-235b-a22b"
AUX_TOL = 1e-6


def _moe(cfg, seed=0):
    jp = jmoe.moe_init(jax.random.key(seed), cfg, jnp.float32)
    return jp, load_module(tmoe.MoE(cfg, torch.float32), jp)


def _x(cfg, seed=1, B=2, S=32):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _lost_an_expert(p, x, cfg, ffn, as_array):
    """The tokens whose output changes when capacity no longer binds: the
    ones that lost an expert at ``cfg``'s capacity."""
    with torch.no_grad():
        y, _ = ffn(p, as_array(x), cfg)
        y_all, _ = ffn(p, as_array(x), cfg.replace(capacity_factor=64.0))
    d = np.abs(np.asarray(y_all) - np.asarray(y)).max(-1)
    return d > 1e-3 * np.abs(np.asarray(y_all)).max()


@pytest.mark.parametrize("arch,cf", [(ARCH, 1.25), (ARCH, 0.25),
                                     (ARCH, 16.0),
                                     ("llama4-maverick-400b-a17b", 0.5)])
def test_moe_ffn_matches_reference(arch, cf):
    cfg = get_config(arch, smoke=True).replace(capacity_factor=cf)
    jp, tp = _moe(cfg)
    x = _x(cfg)
    yj, auxj = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, CTX)
    with torch.no_grad():
        yt, auxt = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
        logits = torch.from_numpy(x).reshape(-1, cfg.d_model) @ tp.router
        ids_t = torch.topk(torch.softmax(logits, -1), cfg.top_k, -1)[1]
    probs_j = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                             @ jp["router"], axis=-1)
    ids_j = jax.lax.top_k(probs_j, cfg.top_k)[1]
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert float(auxt["drop_frac"]) == float(auxj["drop_frac"])
    np.testing.assert_allclose(float(auxt["aux_loss"]),
                               float(auxj["aux_loss"]), rtol=0, atol=AUX_TOL)
    close(yt, yj, F32_TOL)
    if cf < 1:
        assert float(auxt["drop_frac"]) > 0
        lost_t = _lost_an_expert(tp, x, cfg, tmoe.moe_ffn, torch.from_numpy)
        lost_j = _lost_an_expert(jp, x, cfg,
                                 lambda p, a, c: jmoe.moe_ffn(p, a, c, CTX),
                                 jnp.asarray)
        assert lost_t.any()
        np.testing.assert_array_equal(lost_t, lost_j)
    if cf == 16.0:
        assert float(auxt["drop_frac"]) == 0.0


def test_moe_ffn_gradients_match_reference():
    cfg = get_config(ARCH, smoke=True).replace(capacity_factor=0.5)
    jp, tp = _moe(cfg)
    x = _x(cfg)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, cfg, CTX)
        return jnp.sum(y * r) + aux["aux_loss"]

    gp, gx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, xt, cfg)
    out = (y * torch.from_numpy(r)).sum() + aux["aux_loss"]
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(out, [xt] + list(tp.parameters()))
    close(grads[0], gx, F32_TOL)
    for name, g in zip(names, grads[1:]):
        want = np.asarray(gp[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=2e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_group_tokens_is_the_largest_divisor():
    cfg = get_config(ARCH, smoke=True)          # moe_group_tokens = 32
    for n, want in ((64, 32), (30, 30), (45, 15), (4, 4), (33, 11), (1, 1)):
        assert tmoe._group_tokens(cfg, n) == want
        assert jmoe._group_tokens(cfg, n, CTX) == want


def test_moe_routes_and_conserves():
    """``tests/test_models.py``'s checks on the port's own draw."""
    cfg = get_config(ARCH, smoke=True)
    tp = tmoe.moe_init_(tmoe.MoE(cfg, torch.float32),
                        torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        y, aux = tmoe.moe_ffn(tp, x, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux["aux_loss"]) >= 0.99
    assert 0.0 <= float(aux["drop_frac"]) < 0.8


def test_moe_capacity_drops_when_unbalanced():
    cfg = get_config(ARCH, smoke=True).replace(capacity_factor=0.25)
    tp = tmoe.moe_init_(tmoe.MoE(cfg, torch.float32),
                        torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        _, aux = tmoe.moe_ffn(tp, x, cfg)
    assert float(aux["drop_frac"]) > 0.0


# ------------------------------------------------------------ the model
def test_params_tree_round_trips_two_stacked_indices():
    """llama4: ``layers.<g>.dense.<j>.mlp.wi`` is ``layers/dense/mlp/wi``[g,
    j]; the tree the port writes back is the reference's, leaf for
    leaf."""
    cfg, jp, model = model_for("llama4-maverick-400b-a17b")
    assert "layers.0.dense.0.mlp.wi" in dict(model.named_parameters())
    tree = params_tree(model)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert set(flat_t) == set(flat_j)
    for path, want in flat_j.items():
        np.testing.assert_array_equal(flat_t[path].numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_prefill_and_decode_match_reference(arch):
    """At the default capacity: decode routes the B = 2 tokens as one group
    (C = 1 for qwen3-moe), so tokens drop there, in both packages."""
    cfg, jp, model = model_for(arch)
    S = 24
    b = batch_for(cfg, 2, S, seed=1)
    max_len = cfg.frontend_tokens + S + 8
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in b.items()}
    lj, cj = ref_prefill(jp, jbatch(pre), cfg, max_len)
    lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, max_len)
    close(lt, lj, F32_TOL)
    want = init_cache(cfg, 2, max_len, device="cpu")
    assert ct["k"].shape == want["k"].shape == cj["k"].shape == (
        cfg.n_layers // cfg.moe_every, cfg.moe_every, 2, max_len,
        cfg.n_kv_heads, cfg.hd)
    for name in cj:
        close(ct[name], cj[name], F32_TOL)
    nxt = b["tokens"][:, S:S + 1]
    lj2, cj2 = ref_decode(jp, cj, jnp.asarray(nxt), cfg)
    lt2, ct2 = make_serve_step(cfg, device="cpu")(model, ct, nxt)
    close(lt2, lj2, F32_TOL)
    for name in cj2:
        close(ct2[name], cj2[name], F32_TOL)
    if arch == ARCH:    # C = 1 at decode: two tokens routed alike drop half
        with torch.no_grad():
            x = torch.randn((1, 1, cfg.d_model)).expand(2, 1, -1)
            _, aux = tmoe.moe_ffn(model.layers[0].moe.moe, x, cfg)
        assert float(aux["drop_frac"]) == 0.5


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_decode_matches_teacher_forcing(arch):
    """At capacity_factor 16 (as ``tests/test_models.py``): neither path
    drops, so decode routes the last token as prefill(S + 1) does."""
    cfg, _, model = model_for(arch, capacity_factor=16.0)
    S = 23 - cfg.frontend_tokens % 8 if cfg.frontend_tokens else 23
    b = batch_for(cfg, 2, S, seed=3)
    step, full = teacher_forcing(cfg, model, b, S,
                                 cfg.frontend_tokens + S + 8)
    close(step, full.numpy(), F32_TOL)


@pytest.mark.parametrize("arch,remat", [(ARCH, "none"), (ARCH, "nothing"),
                                        (ARCH, "dots"),
                                        ("llama4-maverick-400b-a17b",
                                         "nothing")])
def test_forward_train_matches_reference(arch, remat):
    """Loss (with its aux term) and every gradient leaf against
    ``jax.value_and_grad``, at a capacity where tokens drop; llama4 with
    its patch prefix (masked out of the loss) and the frontend's
    projection."""
    cfg, jp, model = model_for(arch, remat_policy=remat, capacity_factor=0.5)
    b = batch_for(cfg, 2, 32, seed=5, extra=0)
    check_train_against_reference(cfg, jp, model, b)
    with torch.no_grad():
        _, m = forward_train(model, {k: torch.as_tensor(v)
                                     for k, v in b.items()}, cfg)
    assert float(m["aux"]) > 0
