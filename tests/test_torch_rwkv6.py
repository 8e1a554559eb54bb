"""The port's rwkv6 serving path against the reference at the SMOKE config
(2 layers, d = 64, f32), with the reference's own weights carried across by
``params_from_numpy``.

Tolerances: one block and the f32 prefill/decode within 2e-4 (both sides
compute in f32; sums differ in order only).  The bf16 model within 2e-2 of
the magnitude of each output: bf16 rounds at other places in the two
frameworks (XLA keeps a fused chain of elementwise ops in f32, eager torch
rounds after every op), so a logit near 0 can be a few bf16 ulps of the
logits' scale away.  The WKV paths at extreme decays within
``tests/test_models.py``'s atol 1e-4 plus rtol 1e-4: there the chunk's
cumulative log-decays reach |lin| ~ 10^2-10^3, whose f32 ulp becomes a
relative error of ~1e-5-1e-4 in exp(lprev - lin), and jnp.cumsum and
torch.cumsum round those sums differently (by one ulp).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import OPTIMIZED as JAX_OPTIMIZED
from repro.models import rwkv6 as jrw
from repro.models import transformer as jtf
from repro.models.layers import ShardCtx
from repro.optim import adamw as jadamw
from repro_torch.configs import OPTIMIZED, get_config
from repro_torch.core.curation import DataCurator
from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.launch.train import main as train_main
from repro_torch.models import rwkv6 as trw
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            init_cache, init_params,
                                            params_from_numpy)
from repro_torch.optim.adamw import opt_state_from_numpy
from repro_torch.runtime import StragglerMonitor

torch.set_num_threads(1)

CTX = ShardCtx(mesh=None)
ARCH = "rwkv6-7b"
B, S = 2, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config(ARCH, smoke=True)
    jparams = jtf.init_params(cfg, jax.random.key(0))
    model = params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    toks = np.array(jax.random.randint(jax.random.key(42), (B, S + 1), 2,
                                         cfg.vocab))
    return cfg, jparams, model, toks


def test_configs_match_the_reference():
    for smoke_ in (False, True):
        mine = dataclasses.asdict(get_config(ARCH, smoke=smoke_))
        assert mine == dataclasses.asdict(jax_get_config(ARCH, smoke=smoke_))
    full = get_config(ARCH)
    assert full.param_count() == jax_get_config(ARCH).param_count()
    assert OPTIMIZED[ARCH] == JAX_OPTIMIZED[ARCH]
    assert OPTIMIZED[ARCH][0]["wkv_chunk"] == 64
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_from_numpy_holds_the_same_numbers(smoke):
    cfg, jparams, model, _ = smoke
    assert torch.equal(model.embed.table, _t(jparams["embed"]["table"]))
    lay = jparams["layers"]
    for i, blk in enumerate(model.layers):
        assert torch.equal(blk.tmix.wr, _t(lay["tmix"]["wr"][i]))
        assert torch.equal(blk.cmix.wv, _t(lay["cmix"]["wv"][i]))
        assert torch.equal(blk.tmix.ln_out.scale,
                           _t(lay["tmix"]["ln_out"]["scale"][i]))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    bad = dict(_np_tree(jparams), lm_head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(bad, cfg, device="cpu")


def test_init_params_uses_the_reference_distributions():
    cfg = get_config(ARCH, smoke=True)
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, 3, device="cpu")
    c = init_params(cfg, 4, device="cpu")
    jshapes = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.key(0)))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes)}
    for name, p in a.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            want = ref["/".join(["layers"] + parts[2:])]
            assert (cfg.n_layers,) + tuple(p.shape) == want.shape, name
        else:
            assert tuple(p.shape) == ref["/".join(parts)].shape, name
    assert torch.equal(a.lm_head, b.lm_head)              # same seed
    assert not torch.equal(a.lm_head, c.lm_head)          # another seed
    D = cfg.d_model
    gen = torch.Generator().manual_seed(5)
    for blk in (a.layers[0], trw.rwkv_layer_init(gen, cfg, torch.float32)):
        assert (blk.tmix.mu == 0.5).all() and (blk.tmix.w0 == -1).all()
        assert (blk.tmix.u == 0).all() and (blk.ln1.scale == 1).all()
        with torch.no_grad():
            assert abs(float(blk.tmix.wr.std()) * D ** 0.5 - 1) < 0.1
            assert abs(float(blk.tmix.wa.std()) * D ** 0.5 / 0.1 - 1) < 0.1
    with torch.no_grad():
        assert abs(float(a.embed.table.std()) / 0.02 - 1) < 0.1


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["wkv_chunked", "wkv_kernel_route"])
def test_rwkv_block_matches_reference(smoke, use_pallas):
    cfg, jparams, model, _ = smoke
    cfg = cfg.replace(wkv_use_pallas=use_pallas)
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    lp = jax.tree.map(lambda a: a[0], jparams["layers"])
    yj, stj = jrw.rwkv_block(lp, jnp.asarray(x), cfg, CTX)
    before = wkv_forward_cuda.launches
    yt, stt = trw.rwkv_block(model.layers[0], torch.from_numpy(x), cfg)
    assert wkv_forward_cuda.launches == before        # CPU: plain version
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=2e-4, atol=2e-4)
    for name in ("ts_t", "ts_c", "s"):
        np.testing.assert_allclose(stt[name].detach().numpy(),
                                   np.asarray(stj[name]), rtol=2e-4,
                                   atol=2e-4)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _compare_prefill_and_decode(cfg, jparams, model, toks, tol):
    lg_j, cache_j = jtf.forward_prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :S])}, cfg, CTX, max_len=S + 8)
    prefill = make_prefill_step(cfg, device="cpu")
    lg_t, cache_t = prefill(model, {"tokens": toks[:, :S]}, S + 8)
    assert lg_t.dtype == torch.float32 and lg_t.shape == (B, cfg.vocab)
    _close(lg_t.numpy(), lg_j, tol)
    assert set(cache_t) == set(cache_j)
    for name in cache_j:
        _close(_np(cache_t[name]), cache_j[name], tol)
    lg_j2, cache_j2 = jtf.forward_decode(jparams, cache_j,
                                         jnp.asarray(toks[:, S:S + 1]), cfg,
                                         CTX)
    lg_t2, cache_t2 = make_serve_step(cfg, device="cpu")(
        model, cache_t, toks[:, S:S + 1])
    _close(lg_t2.numpy(), lg_j2, tol)
    for name in cache_j2:
        _close(_np(cache_t2[name]), cache_j2[name], tol)


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def test_prefill_and_decode_match_reference(smoke):
    cfg, jparams, model, toks = smoke
    _compare_prefill_and_decode(cfg, jparams, model, toks, 2e-4)


def test_prefill_and_decode_match_reference_bf16():
    cfg = get_config(ARCH, smoke=True).replace(dtype="bfloat16")
    jparams = jtf.init_params(cfg, jax.random.key(0))
    model = params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    assert model.lm_head.dtype == torch.bfloat16
    toks = np.array(jax.random.randint(jax.random.key(7), (B, S + 1), 2,
                                         cfg.vocab))
    _compare_prefill_and_decode(cfg, jparams, model, toks, 2e-2)


def test_decode_matches_teacher_forcing(smoke):
    """prefill(prompt) + decode(next) equals prefill(prompt + next) at its
    last position, on the port alone (``tests/test_models.py``'s check)."""
    cfg, _, model, toks = smoke
    with torch.no_grad():
        _, cache = forward_prefill(model, {"tokens": torch.from_numpy(
            toks[:, :S])}, cfg)
        lg_step, cache2 = forward_decode(model, cache, torch.from_numpy(
            toks[:, S:S + 1]), cfg)
        lg_full, cache_full = forward_prefill(model, {"tokens": torch.from_numpy(
            toks)}, cfg)
    np.testing.assert_allclose(lg_step.numpy(), lg_full.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert int(cache2["pos"]) == S + 1 == int(cache_full["pos"])
    np.testing.assert_allclose(cache2["s"].numpy(), cache_full["s"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_greedy_decode_from_a_zero_cache(smoke):
    """Decoding a prompt token by token from ``init_cache`` gives the
    prefill's cache and logits."""
    cfg, _, model, toks = smoke
    serve = make_serve_step(cfg, device="cpu")
    cache = init_cache(cfg, B, S, device="cpu")
    assert cache["s"].shape == (cfg.n_layers, B, cfg.d_model // 32, 32, 32)
    for t in range(S):
        lg, cache = serve(model, cache, toks[:, t:t + 1])
    lg_p, cache_p = make_prefill_step(cfg, device="cpu")(
        model, {"tokens": toks[:, :S]})
    np.testing.assert_allclose(lg.numpy(), lg_p.numpy(), rtol=1e-4,
                               atol=1e-4)
    for name in cache_p:
        np.testing.assert_allclose(_np(cache[name]), _np(cache_p[name]),
                                   rtol=1e-4, atol=1e-4)


DECAY_TOL = dict(atol=1e-4, rtol=1e-4)


def test_wkv_paths_match_reference_at_extreme_decays():
    """``tests/test_models.py``'s extreme-decay case: the port's chunked and
    recurrent paths against the reference's, and against each other."""
    rng = np.random.default_rng(0)
    Bx, T, H, K = 2, 64, 2, 8
    args = [rng.normal(size=(Bx, T, H, K)).astype(np.float32)
            for _ in range(3)]
    lw = (-np.exp(rng.uniform(-8, 4, size=(Bx, T, H, K)))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = rng.normal(size=(Bx, H, K, K)).astype(np.float32)
    arrs = args + [lw, u, s0]
    tj = [jnp.asarray(a) for a in arrs]
    tt = [torch.from_numpy(a) for a in arrs]
    for chunk in (16, 24):          # 24: T % c != 0, neutral padding
        ocj, scj = jrw.wkv_chunked(*tj, chunk)
        oct_, sct = trw.wkv_chunked(*tt, chunk)
        np.testing.assert_allclose(oct_.numpy(), np.asarray(ocj), **DECAY_TOL)
        np.testing.assert_allclose(sct.numpy(), np.asarray(scj), **DECAY_TOL)
    orj, srj = jrw.wkv_recurrent(*tj)
    ort, srt = trw.wkv_recurrent(*tt)
    np.testing.assert_allclose(ort.numpy(), np.asarray(orj), **DECAY_TOL)
    np.testing.assert_allclose(srt.numpy(), np.asarray(srj), **DECAY_TOL)
    np.testing.assert_allclose(oct_.numpy(), ort.numpy(), **DECAY_TOL)
    # the bf16 compute dtype: both round the same intra-chunk operands to
    # bf16 and multiply them exactly in f32, so the sums' order is all that
    # differs
    obj, sbj = jrw.wkv_chunked(*tj, 16, compute_dtype=jnp.bfloat16)
    obt, sbt = trw.wkv_chunked(*tt, 16, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(obt.numpy(), np.asarray(obj), **DECAY_TOL)
    np.testing.assert_allclose(sbt.numpy(), np.asarray(sbj), **DECAY_TOL)
    assert not np.array_equal(obt.numpy(), oct_.numpy())


def test_entry_points_refuse_cuda_without_a_card(monkeypatch, smoke):
    cfg, jparams, _, _ = smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jopt = jax.tree.map(np.asarray, jadamw.init(jparams, jadamw.AdamWConfig()))
    for call in (lambda: init_params(cfg),
                 lambda: params_from_numpy(_np_tree(jparams), cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg),
                 lambda: make_train_step(cfg),
                 lambda: opt_state_from_numpy(jopt, cfg),
                 lambda: DataCurator(n_sites=2),
                 lambda: StragglerMonitor(n_sites=2),
                 lambda: train_main(["--arch", ARCH, "--smoke"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    encdec = get_config("seamless-m4t-medium", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        make_prefill_step(encdec)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_serve_step(cfg, mesh=object(), device="cpu")
