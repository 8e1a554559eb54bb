"""The port's encdec family (``models/transformer.py``'s ``EncDecModel``:
the encoder over the audio frames, the decoder's self- and
cross-attention, training, prefill and decode) against the reference, at
SMOKE widths (2 + 2 layers, frontend_tokens 8), with the reference's own
weights carried across by ``params_from_numpy``.

The batch follows the reference's ``launch/shapes.py::input_structs``
rule: frames (B, max(L // 4, 8), frontend_dim) beside tokens (B, L); a
prefill may take another number of frames than ``frontend_tokens``, and
its cache's ``ck`` / ``cv`` then hold that many.

Tolerances as ``tests/test_torch_dense.py``: f32 outputs within 1e-5 of
their magnitude, gradient leaves within 2e-5 of their largest, bf16
outputs within 2e-2; decode against teacher forcing on the port alone
within 1e-5.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import OPTIMIZED as JAX_OPTIMIZED
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch.configs import OPTIMIZED, get_config
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import (build_model, forward_decode,
                                            forward_prefill, init_cache,
                                            init_params, params_from_numpy,
                                            reference_key)
from repro_torch.optim import adamw
from test_torch_dense import (BF16_TOL, F32_TOL, check_train_against_reference,
                              close, jbatch, leaf, np_tree, ref_decode,
                              ref_prefill, tbatch)

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"


@functools.lru_cache(maxsize=None)
def ref_params(dtype, seed):
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    return jax.jit(jtf.init_params, static_argnums=0)(cfg,
                                                      jax.random.key(seed))


def model_for(dtype="float32", seed=0, **over):
    cfg = get_config(ARCH, smoke=True).replace(attn_q_chunk=8, dtype=dtype,
                                               **over)
    jp = ref_params(dtype, seed)
    return cfg, jp, params_from_numpy(np_tree(jp), cfg, device="cpu")


def encdec_batch(cfg, B, L, seed, n_frames=None, extra=0):
    """tokens (B, L + extra), frames (B, n_frames or max(L // 4, 8),
    frontend_dim) f32."""
    rng = np.random.default_rng(seed)
    n_frames = n_frames or max(L // 4, 8)
    return {"tokens": rng.integers(2, cfg.vocab, (B, L + extra)).astype(
                np.int32),
            "frames": rng.normal(size=(B, n_frames, cfg.frontend_dim)).astype(
                np.float32)}


# ------------------------------------------------------------ config, params
def test_config_and_params_match_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
    full = get_config(ARCH)
    assert full.param_count() == jax_get_config(ARCH).param_count() \
        == 977_757_184
    assert OPTIMIZED[ARCH] == JAX_OPTIMIZED[ARCH]
    meta = build_model(full, "meta")
    assert not hasattr(meta, "layers")
    assert len(meta.enc_layers) == len(meta.dec_layers) == 12
    jshapes = jax.eval_shape(lambda: jtf.init_params(full,
                                                     jax.random.key(0)))
    want = {"/".join(str(k.key) for k in path): leaf_
            for path, leaf_ in jax.tree_util.tree_leaves_with_path(jshapes)}
    seen = set()
    for name, p in meta.named_parameters():
        key, index = reference_key(name)
        w = want["/".join(key)]
        assert tuple(w.shape[len(index):]) == tuple(p.shape), name
        assert str(w.dtype) == str(p.dtype).replace("torch.", ""), name
        seen.add("/".join(key))
    assert seen == set(want)
    assert sum(p.numel() for p in meta.parameters()) == sum(
        int(np.prod(w.shape)) for w in want.values())


def test_params_from_numpy_and_init_params():
    cfg, jp, model = model_for()
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), leaf(jp, name))
    assert model.enc_layers[0].xattn is None
    a = init_params(cfg, 3, device="cpu").requires_grad_(False)
    D = cfg.d_model
    for lyr in a.dec_layers:
        assert (lyr.ln_x.scale == 1).all()
        assert abs(float(lyr.xattn.wk.std()) * D ** 0.5 - 1) < 0.15
        assert not torch.equal(lyr.xattn.wq, lyr.attn.wq)
    assert abs(float(a.frontend.proj.std()) * cfg.frontend_dim ** 0.5 - 1) \
        < 0.2


# ------------------------------------------------------------ training
@pytest.mark.parametrize("remat,n_frames", [("none", None), ("nothing", None),
                                            ("none", 11)])
def test_forward_train_matches_reference(remat, n_frames):
    """Loss and every gradient leaf (the encoder's, the frontend's and the
    cross-attention's included) against ``jax.value_and_grad``: 32 tokens
    and max(32 // 4, 8) = 8 frames, or 11."""
    cfg, jp, model = model_for(remat_policy=remat)
    b = encdec_batch(cfg, 2, 32, seed=5, n_frames=n_frames)
    check_train_against_reference(cfg, jp, model, b)


def test_frames_reach_the_encoder_not_the_decoder():
    """The decoder's logits are (B, L, V) over the tokens alone (no frame
    prefix), and they depend on the frames through cross-attention."""
    cfg, _, model = model_for()
    b = tbatch(encdec_batch(cfg, 2, 16, seed=6))
    x, mask = ttf._embed_inputs(model, b, cfg)
    assert x.shape[:2] == (2, 16) and bool(mask.all())
    with torch.no_grad():
        l1, _ = forward_prefill(model, b, cfg)
        l2, _ = forward_prefill(model, dict(b, frames=b["frames"] * 2), cfg)
    assert (l1 - l2).abs().max() > 1e-3


def test_train_step_moves_frames_to_the_device():
    cfg, _, model = model_for()
    step, optc = make_train_step(cfg, device="cpu")
    opt = adamw.init(model, optc)
    before = model.frontend.proj.detach().clone()
    model, opt, m = step(model, opt, encdec_batch(cfg, 2, 32, seed=8))
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1
    assert not torch.equal(before, model.frontend.proj)


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("n_frames", [8, 11])
def test_prefill_and_decode_match_reference(n_frames):
    """Prefill of 24 tokens and two decode steps, with frontend_tokens (8)
    frames or 11: the cache's ck / cv hold as many."""
    cfg, jp, model = model_for()
    S, max_len = 24, 32
    b = encdec_batch(cfg, 2, S, seed=1, n_frames=n_frames, extra=2)
    pre = dict(b, tokens=b["tokens"][:, :S])
    lj, cj = ref_prefill(jp, jbatch(pre), cfg, max_len)
    lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, max_len)
    close(lt, lj, F32_TOL)
    want = init_cache(cfg.replace(frontend_tokens=n_frames), 2, max_len,
                      device="cpu")
    assert set(ct) == set(cj) == set(want)
    assert ct["ck"].shape == (cfg.n_layers, 2, n_frames, cfg.n_kv_heads,
                              cfg.hd)
    for name in cj:
        assert ct[name].shape == want[name].shape == cj[name].shape, name
        assert ct[name].dtype == want[name].dtype, name
        close(ct[name], cj[name], F32_TOL)
    for t in range(2):
        nxt = b["tokens"][:, S + t:S + t + 1]
        lj, cj = ref_decode(jp, cj, jnp.asarray(nxt), cfg)
        lt, ct = make_serve_step(cfg, device="cpu")(model, ct, nxt)
        close(lt, lj, F32_TOL)
        for name in cj:
            close(ct[name], cj[name], F32_TOL)


def test_prefill_and_decode_match_reference_bf16():
    cfg, jp, model = model_for("bfloat16")
    b = encdec_batch(cfg, 2, 24, seed=2, extra=1)
    pre = dict(b, tokens=b["tokens"][:, :24])
    lj, cj = ref_prefill(jp, jbatch(pre), cfg, 32)
    lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, 32)
    assert ct["ck"].dtype == torch.bfloat16
    close(lt, lj, BF16_TOL)
    lj, _ = ref_decode(jp, cj, jnp.asarray(b["tokens"][:, 24:]), cfg)
    lt, _ = make_serve_step(cfg, device="cpu")(model, ct, b["tokens"][:, 24:])
    close(lt, lj, BF16_TOL)


@pytest.mark.parametrize("S", [7, 23])
def test_decode_matches_teacher_forcing(S):
    """prefill(S) + decode(token S) equals prefill(S + 1)'s last logits, on
    the port alone, with the same frames."""
    cfg, _, model = model_for()
    b = encdec_batch(cfg, 2, S, seed=3, n_frames=9, extra=1)
    with torch.inference_mode():
        _, cache = forward_prefill(model, tbatch(dict(
            b, tokens=b["tokens"][:, :S])), cfg, S + 8)
        step, _ = forward_decode(model, cache, torch.as_tensor(
            b["tokens"][:, S:]), cfg)
        full, _ = forward_prefill(model, tbatch(b), cfg, S + 8)
    close(step, full.numpy(), F32_TOL)


def test_init_cache_shapes():
    cfg = get_config(ARCH, smoke=True)
    c = init_cache(cfg, 3, 20, device="cpu")
    assert c["k"].shape == (2, 3, 20, 4, 16)
    assert c["ck"].shape == c["cv"].shape == (2, 3, 8, 4, 16)
    assert set(c) == {"k", "v", "ck", "cv", "kpos", "pos"}
    full = init_cache(get_config(ARCH), 4, 4096, device="meta")
    assert full["ck"].shape == (12, 4, 1024, 16, 64)
    assert full["ck"].dtype == torch.bfloat16
