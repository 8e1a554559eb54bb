"""The port's dense family and shared layers (``models/layers.py``'s RoPE,
attention and MLPs, ``models/transformer.py``'s dense prefill, decode and
training) against the reference, at SMOKE widths, with the reference's own
weights carried across by ``params_from_numpy``.

Tolerances: in f32 both sides compute the same function and sum in other
orders, so layers and logits are held within 1e-5 of their magnitude
(``_close``; 3e-6 is seen) and gradient leaves within 2e-5 of their
largest magnitude (as ``tests/test_torch_train.py``).  In bf16 the two
frameworks round at other places (XLA keeps a fused elementwise chain in
f32, eager torch rounds after each op), so a bf16 output is held within
2e-2 of its magnitude.  Decode against teacher forcing on the port alone
is held to 1e-5 in f32: one function, two evaluation orders.
"""
import dataclasses
import functools
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import OPTIMIZED as JAX_OPTIMIZED
from repro.configs import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models.layers import ShardCtx
from repro.optim import adamw as jadamw
from repro_torch.configs import OPTIMIZED, get_config
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as tl
from repro_torch.models.transformer import (build_model, forward_decode,
                                            forward_prefill, forward_train,
                                            init_cache, init_params,
                                            params_from_numpy, params_tree,
                                            reference_key)
from repro_torch.optim import adamw

torch.set_num_threads(1)

CTX = ShardCtx(mesh=None)
PORTED = ["llava-next-mistral-7b", "qwen2.5-32b", "qwen2-72b", "granite-20b",
          "h2o-danube-1.8b", "llama4-maverick-400b-a17b",
          "qwen3-moe-235b-a22b"]
F32_TOL = 1e-5
BF16_TOL = 2e-2
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def leaf(tree, name):
    key, index = reference_key(name)
    for part in key:
        tree = tree[part]
    return np.asarray(jnp.asarray(tree).astype(jnp.float32))[index]


def load_module(mod: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a reference parameter dict (one layer's) into ``mod``."""
    for name, p in mod.named_parameters():
        node = tree
        for part in name.split("."):
            node = node[part]
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(jnp.asarray(node).astype(
                jnp.float32))).to(p.dtype))
    return mod


def batch_for(cfg, B, S, seed, extra=1):
    """Tokens (B, S + extra) and, for a vlm_patches arch, its patches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(2, cfg.vocab, (B, S + extra)).astype(
        np.int32)}
    if cfg.frontend == "vlm_patches":
        b["patches"] = rng.normal(size=(B, cfg.frontend_tokens,
                                        cfg.frontend_dim)).astype(np.float32)
    return b


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def ref_params(arch, dtype, seed):
    """The reference's ``init_params`` at SMOKE, jitted and drawn once per
    file; with qkv biases, those drawn N(0, 0.5), since init gives zeros,
    which would hide them.  Callers do not mutate it."""
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jp = jax.jit(jtf.init_params, static_argnums=0)(cfg, jax.random.key(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        attn = jp["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(size=attn[name].shape) * 0.5,
                                     attn[name].dtype)
    return jp


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    full = get_config(arch)
    for active in (False, True):
        assert full.param_count(active) == \
            jax_get_config(arch).param_count(active)
    assert OPTIMIZED[arch] == JAX_OPTIMIZED[arch]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "seamless-m4t-medium"])
def test_unported_families_still_raise(arch):
    """The two families the port refused until its last slice (rglru_hybrid
    and encdec) now configure and build: the reference's configs, the
    reference's parameter tree on the meta device, and the serving steps
    on the CPU; an unknown family raises."""
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count()
    jshapes = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.key(0)))
    assert sum(p.numel() for p in build_model(cfg, "meta").parameters()) == \
        sum(int(np.prod(w.shape)) for w in jax.tree.leaves(jshapes))
    smoke = get_config(arch, smoke=True)
    assert callable(make_prefill_step(smoke, device="cpu"))
    assert callable(make_serve_step(smoke, device="cpu"))
    with pytest.raises(ValueError, match="family"):
        build_model(smoke.replace(family="ssm"), "meta")


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("theta,dtype", [(1e4, "float32"), (1e6, "float32"),
                                         (1e6, "bfloat16")])
def test_rope_matches_reference(theta, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 9000, size=(1, 24)).astype(np.int32)
    want = jl.rope(jnp.asarray(x, dtype), jnp.asarray(pos), theta)
    got = tl.rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                  torch.from_numpy(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# (arch, config overrides, Sq): attn_q_chunk = 8, so Sq = 24 takes the
# chunked path and 12 the unchunked one
ATTN_CASES = {
    "gqa_chunked": ("h2o-danube-1.8b", {"sliding_window": 0}, 24),
    "gqa_unchunked": ("h2o-danube-1.8b", {"sliding_window": 0}, 12),
    "mqa_granite": ("granite-20b", {}, 24),
    "bias_qwen25": ("qwen2.5-32b", {}, 24),
    "window_chunked": ("h2o-danube-1.8b", {"sliding_window": 8}, 24),
    "window_unchunked": ("h2o-danube-1.8b", {"sliding_window": 8}, 12),
    "chunk_remat": ("qwen2.5-32b", {"attn_chunk_remat": True}, 24),
    "bf16_gqa": ("h2o-danube-1.8b", {"dtype": "bfloat16"}, 24),
}


def _attn_setup(case):
    arch, over, Sq = ATTN_CASES[case]
    cfg = get_config(arch, smoke=True).replace(attn_q_chunk=8, **over)
    jp = jl.attn_init(jax.random.key(3), cfg, jnp.dtype(cfg.dtype))
    if cfg.qkv_bias:
        rng = np.random.default_rng(4)
        jp = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5, v.dtype)
                  if k.startswith("b") else v) for k, v in jp.items()}
    tp = load_module(tl.Attention(cfg, getattr(torch, cfg.dtype)), jp)
    x = np.random.default_rng(5).normal(size=(2, Sq, cfg.d_model)).astype(
        np.float32)
    return cfg, jp, tp, x


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    """Forward and input gradient of one attention block, with the window
    the case sets."""
    cfg, jp, tp, x = _attn_setup(case)
    dt = getattr(torch, cfg.dtype)
    assert cfg.n_heads // cfg.n_kv_heads in (2, 4)
    tol = F32_TOL if cfg.dtype == "float32" else BF16_TOL

    def jf(xx):
        return jl.attention(jp, xx, cfg, CTX, window=cfg.sliding_window)

    r = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def ref(xx, ct):
        out, vjp = jax.vjp(jf, xx)
        zeros = jax.tree.map(jnp.zeros_like, out[1])
        return out, vjp((ct, zeros))[0]

    (yj, (kj, vj)), gj = ref(jnp.asarray(x, cfg.dtype),
                             jnp.asarray(r, cfg.dtype))
    xt = torch.from_numpy(x).to(dt).requires_grad_(True)
    yt, (kt, vt) = tl.attention(tp, xt, cfg, window=cfg.sliding_window)
    assert yt.dtype == dt and yt.shape == x.shape
    close(yt.detach(), yj, tol)
    close(kt.detach(), kj, tol)
    close(vt.detach(), vj, tol)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(r).to(dt))
    close(gt, gj, tol)


def test_attention_decode_kv_and_grouping():
    """With a cache given (kv, kpos, kv_valid), as decode calls it; and
    query head h reads kv head h // G: tiling the kv heads
    (``Tensor.repeat``) instead of repeating each (``repeat_interleave``)
    gives another answer."""
    cfg, jp, tp, x = _attn_setup("gqa_unchunked")
    rng = np.random.default_rng(7)
    W, B = 10, 2
    k = rng.normal(size=(B, W, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.normal(size=(B, W, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    kpos = np.array([10, 11, 2, 3, 4, 5, 6, 7, 8, -1], np.int32)
    xq = x[:, :1]
    jkv = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
           jnp.asarray(kpos >= 0))
    tkv = (torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kpos),
           torch.from_numpy(kpos >= 0))
    for pos, window in ((11, 0), (11, 5), (8, 0)):
        yj, _ = jl.attention(jp, jnp.asarray(xq), cfg, CTX, kv=jkv,
                             positions=jnp.full((1,), pos, jnp.int32),
                             window=window)
        yt, _ = tl.attention(tp, torch.from_numpy(xq), cfg, kv=tkv,
                             positions=torch.full((1,), pos,
                                                  dtype=torch.int32),
                             window=window)
        close(yt, yj, F32_TOL)
    G = cfg.n_heads // cfg.n_kv_heads
    q = torch.from_numpy(rng.normal(size=(B, 3, cfg.n_heads, cfg.hd)).astype(
        np.float32))
    kk, vv = torch.from_numpy(k[:, :3]), torch.from_numpy(v[:, :3])
    pos3 = torch.arange(3)
    got = tl._sdpa(q, kk, vv, pos3, pos3, None, causal=True, window=0)
    want = tl._sdpa(q, kk.repeat_interleave(G, 2), vv.repeat_interleave(G, 2),
                    pos3, pos3, None, causal=True, window=0)
    tiled = tl._sdpa(q, kk.repeat(1, 1, G, 1), vv.repeat(1, 1, G, 1), pos3,
                     pos3, None, causal=True, window=0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (got - tiled).abs().max() > 1e-2


@pytest.mark.parametrize("arch,dtype", [("h2o-danube-1.8b", "float32"),
                                        ("granite-20b", "float32"),
                                        ("h2o-danube-1.8b", "bfloat16"),
                                        ("granite-20b", "bfloat16")])
def test_mlp_matches_reference(arch, dtype):
    """SwiGLU, and granite's GELU (jax.nn.gelu's tanh approximation: the
    erf form is ~1e-4 of the magnitude away, beyond the f32
    tolerance)."""
    cfg = get_config(arch, smoke=True)
    jp = jl.mlp_init(jax.random.key(1), cfg.d_model, cfg.d_ff,
                     jnp.dtype(dtype), cfg.mlp_type)
    tp = load_module(tl.MLP(cfg.d_model, cfg.d_ff, getattr(torch, dtype),
                            cfg.mlp_type), jp)
    assert (tp.wg is None) == (cfg.mlp_type == "gelu")
    x = np.random.default_rng(2).normal(size=(2, 8, cfg.d_model)).astype(
        np.float32) * 3
    want = jl.mlp(jp, jnp.asarray(x, dtype), CTX)
    got = tl.mlp(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    if cfg.mlp_type == "gelu" and dtype == "float32":
        h = torch.from_numpy(x) @ tp.wi
        erf = torch.nn.functional.gelu(h) @ tp.wo
        assert (erf - got).abs().max() > F32_TOL * float(
            np.abs(np.asarray(want)).max())


# ------------------------------------------------------------ the model
DENSE = ["qwen2.5-32b", "h2o-danube-1.8b", "llava-next-mistral-7b",
         "granite-20b"]


def model_for(arch, dtype="float32", seed=0, **over):
    """(cfg with query chunks of 8 and ``over``, the reference's params,
    the port's model from them)."""
    cfg = get_config(arch, smoke=True).replace(attn_q_chunk=8, dtype=dtype,
                                               **over)
    jp = ref_params(arch, dtype, seed)
    return cfg, jp, params_from_numpy(np_tree(jp), cfg, device="cpu")


def test_params_from_numpy_holds_the_same_numbers():
    cfg, jp, model = model_for("llava-next-mistral-7b")
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), leaf(jp, name))
    tree = params_tree(model)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tree)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jp))
    bad = np_tree(jp)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :3]
    with pytest.raises(ValueError, match="attn.wq"):
        params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_uses_the_reference_distributions(arch):
    cfg = get_config(arch, smoke=True)
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, 3, device="cpu")
    c = init_params(cfg, 4, device="cpu")
    jshapes = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.key(0)))
    ref = {"/".join(str(k.key) for k in path): leaf_
           for path, leaf_ in jax.tree_util.tree_leaves_with_path(jshapes)}
    seen = set()
    for name, p in a.named_parameters():
        key, index = reference_key(name)
        want = ref["/".join(key)]
        seen.add("/".join(key))
        assert tuple(want.shape[len(index):]) == tuple(p.shape), name
        assert str(want.dtype) == str(p.dtype).replace("torch.", ""), name
    assert seen == set(ref)
    assert torch.equal(a.lm_head, b.lm_head)
    assert not torch.equal(a.lm_head, c.lm_head)
    D = cfg.d_model
    with torch.no_grad():
        for grp in a.layers:
            lyrs = grp.sublayers() if cfg.family == "moe" else [grp]
            for lyr in lyrs:
                assert (lyr.ln1.scale == 1).all()
                assert abs(float(lyr.attn.wq.std()) * D ** 0.5 - 1) < 0.15
                if lyr.attn.bq is not None:
                    assert (lyr.attn.bq == 0).all()
                if lyr.moe is not None:
                    Fe = cfg.moe_d_ff
                    assert lyr.moe.router.dtype == torch.float32
                    assert abs(float(lyr.moe.router.std()) * D ** 0.5 - 1) \
                        < 0.15
                    assert abs(float(lyr.moe.we_o.std()) * Fe ** 0.5 - 1) \
                        < 0.15
                else:
                    assert abs(float(lyr.mlp.wo.std()) * cfg.d_ff ** 0.5
                               - 1) < 0.15
        assert abs(float(a.embed.table.std()) / 0.02 - 1) < 0.1


@pytest.mark.parametrize("arch", PORTED)
def test_decay_mask_matches_reference(arch):
    """AdamW's no-decay set over every port parameter is the reference's
    over its pytree paths ("u" matches ``router``, so the path must come
    out exactly)."""
    cfg = get_config(arch)
    jshapes = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.key(0)))
    ref = {"/".join(str(k.key) for k in path): jadamw._decay_mask(path)
           for path, _ in jax.tree_util.tree_leaves_with_path(jshapes)}
    mine = {adamw.reference_path(n): adamw._decay_mask(n)
            for n, _ in build_model(cfg, "meta").named_parameters()}
    assert mine == ref
    if cfg.family == "moe":
        assert mine["layers/moe/moe/router"] is False


def ref_prefill(jp, batch, cfg, max_len):
    return jax.jit(lambda p, b: jtf.forward_prefill(p, b, cfg, CTX,
                                                    max_len=max_len))(jp, batch)


def ref_decode(jp, cache, tokens, cfg):
    return jax.jit(lambda p, c, t: jtf.forward_decode(p, c, t, cfg, CTX))(
        jp, cache, tokens)


def _prefill_and_decode(cfg, jp, model, b, S, max_len, tol):
    """Prefill of S tokens and one decode step on both sides."""
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in b.items()}
    lj, cj = ref_prefill(jp, jbatch(pre), cfg, max_len)
    lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, max_len)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    close(lt, lj, tol)
    want = init_cache(cfg, lt.shape[0], max_len, device="cpu")
    assert set(ct) == set(cj) == set(want)
    for name in cj:
        assert ct[name].shape == want[name].shape == cj[name].shape, name
        assert ct[name].dtype == want[name].dtype, name
        close(ct[name], cj[name], tol)
    nxt = b["tokens"][:, S:S + 1]
    lj2, cj2 = ref_decode(jp, cj, jnp.asarray(nxt), cfg)
    lt2, ct2 = make_serve_step(cfg, device="cpu")(model, ct, nxt)
    close(lt2, lj2, tol)
    for name in cj2:
        close(ct2[name], cj2[name], tol)
    return lt, lt2


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    """The prompt outgrows danube's window (16 at SMOKE), so its ring
    wraps: the cache keeps the last 16 positions at slot p % 16."""
    cfg, jp, model = model_for(arch)
    S = 24
    b = batch_for(cfg, 2, S, seed=1)
    max_len = cfg.frontend_tokens + S + 8
    _prefill_and_decode(cfg, jp, model, b, S, max_len, F32_TOL)


def test_prefill_and_decode_match_reference_bf16():
    cfg, jp, model = model_for("qwen2.5-32b", dtype="bfloat16")
    assert model.lm_head.dtype == torch.bfloat16
    b = batch_for(cfg, 2, 24, seed=2)
    _prefill_and_decode(cfg, jp, model, b, 24, 40, BF16_TOL)


def teacher_forcing(cfg, model, b, S, max_len=None):
    """(decode of token S after prefill(S), last logits of prefill(S + 1))
    on the port alone."""
    with torch.inference_mode():
        pre = tbatch({k: (v[:, :S] if k == "tokens" else v)
                      for k, v in b.items()})
        _, cache = forward_prefill(model, pre, cfg, max_len)
        step, _ = forward_decode(model, cache, torch.as_tensor(
            b["tokens"][:, S:S + 1]), cfg)
        full, _ = forward_prefill(model, tbatch(
            {k: (v[:, :S + 1] if k == "tokens" else v)
             for k, v in b.items()}), cfg, max_len)
    return step, full


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch):
    """prefill(S) + decode(token S) equals prefill(S + 1)'s last logits.
    S + 1 = 24 (+ the patches) is a multiple of attn_q_chunk = 8, so
    prefill(S + 1) takes the chunked attention and prefill(S) the
    unchunked one.  The ring is sized for generation (max_len = S + 8): a
    full-attention cache of width S would hold no slot for token S."""
    cfg, _, model = model_for(arch)
    S = 23 - cfg.frontend_tokens % 8 if cfg.frontend_tokens else 23
    b = batch_for(cfg, 2, S, seed=3)
    assert (cfg.frontend_tokens + S + 1) % 8 == 0
    step, full = teacher_forcing(cfg, model, b, S,
                                 cfg.frontend_tokens + S + 8)
    close(step, full.numpy(), F32_TOL)


def test_greedy_decode_from_a_zero_cache():
    """Decoding a prompt token by token from ``init_cache`` (a window of 16
    over 24 tokens: the ring wraps) gives the prefill's logits and, on
    the slots still in the window, its cache."""
    cfg, _, model = model_for("h2o-danube-1.8b")
    S = 24
    toks = batch_for(cfg, 2, S, seed=4)["tokens"]
    serve = make_serve_step(cfg, device="cpu")
    cache = init_cache(cfg, 2, S, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, cfg.sliding_window,
                                cfg.n_kv_heads, cfg.hd)
    for t in range(S):
        lg, cache = serve(model, cache, toks[:, t:t + 1])
    lg_p, cache_p = make_prefill_step(cfg, device="cpu")(
        model, {"tokens": toks[:, :S]}, S)
    close(lg, lg_p.numpy(), F32_TOL)
    for name in cache_p:
        close(cache[name], cache_p[name].float().numpy(), F32_TOL)


def test_sliding_window_limits_attention():
    """``tests/test_models.py``'s check on the port: with SWA, logits at t
    do not depend on tokens more than n_layers * window behind."""
    cfg, _, model = model_for("h2o-danube-1.8b", sliding_window=8)
    rng = np.random.default_rng(1)
    t1 = rng.integers(2, cfg.vocab, (1, 40))
    t2 = t1.copy()
    t2[:, :6] = rng.integers(2, cfg.vocab, (1, 6))

    def logits(t):
        with torch.no_grad():
            out = []
            for S in (3, 22, 30, 40):   # last logits of each prefix
                lg, _ = forward_prefill(model, {"tokens": torch.as_tensor(
                    t[:, :S])}, cfg)
                out.append(lg)
            return out

    l1, l2 = logits(t1), logits(t2)
    assert (l1[0] - l2[0]).abs().max() > 1e-3      # near the start
    for a, b in zip(l1[1:], l2[1:]):              # from 5 + 16 = 21 on
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ training
def ref_loss_and_grads(cfg, jp, b):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.forward_train(p, jbatch(b), cfg, CTX),
        has_aux=True))(jp)
    return loss, metrics, grads


def check_train_against_reference(cfg, jp, model, b):
    loss_j, met_j, grads_j = ref_loss_and_grads(cfg, jp, b)
    loss_t, met_t = forward_train(model, tbatch(b), cfg)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met_t["aux"].detach()),
                               float(met_j["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    named = dict(model.named_parameters())
    grads_t = torch.autograd.grad(loss_t, list(named.values()))
    for (name, _), g in zip(named.items(), grads_t):
        want = leaf(grads_j, name)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)
    return grads_t


@pytest.mark.parametrize("remat", ["none", "nothing", "dots"])
def test_forward_train_matches_reference(remat):
    """qwen2.5 (qkv biases drawn non-zero), 32 tokens in query chunks of 8
    with chunk remat: loss and every gradient leaf against
    ``jax.value_and_grad``; the remat policies agree bit for bit."""
    cfg, jp, model = model_for("qwen2.5-32b", remat_policy=remat,
                            attn_chunk_remat=True)
    b = batch_for(cfg, 2, 32, seed=5, extra=0)
    grads = check_train_against_reference(cfg, jp, model, b)
    if remat != "none":
        loss, _ = forward_train(model, tbatch(b), cfg.replace(
            remat_policy="none", attn_chunk_remat=False))
        plain = torch.autograd.grad(loss, list(model.parameters()))
        for g, p in zip(grads, plain):
            assert torch.equal(g, p)


def test_launchers_refuse_a_frontend_arch(tmp_path, monkeypatch):
    """``ROADMAP.md`` queue 3 item 8: the reference's launcher feeds tokens
    only and fails on llava (``KeyError: 'patches'``); the port's refuses
    the arch, naming that item."""
    argv = ["--arch", "llava-next-mistral-7b", "--smoke", "--steps", "1",
            "--ckpt-dir", str(tmp_path / "ref")]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(KeyError, match="patches"):
        jtrain.main()
    with pytest.raises(ValueError, match="queue 3, item 8"):
        ttrain.main(argv[:-1] + [str(tmp_path / "port"), "--device", "cpu"])
