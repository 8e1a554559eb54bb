"""The port's rglru_hybrid family (``models/rglru.py``: the RG-LRU block,
its conv and its scan; ``models/transformer.py``'s groups, tail, training,
prefill and decode) against the reference, at SMOKE widths (4 layers: one
group of 2 recurrent + 1 local-attention layer, and a tail of one), with
the reference's own weights carried across by ``params_from_numpy``.

The reference initialises the gates ``gate_{r,i}_{w,b}`` to zero, which
would hide a swapped r / i, so every parity test draws them N(0, 1).

Tolerances (as ``tests/test_torch_dense.py``): in f32 both sides compute
the same function in other orders (the scan's products come in another
order than XLA's ``associative_scan`` tree), so outputs and logits are held
within 1e-5 of their magnitude and gradient leaves within 2e-5 of their
largest; a bf16 block within 2e-2, and the bf16 model's logits within
1.25 x the reference's own bf16 distance from its f32 run
(``test_prefill_and_decode_match_reference_bf16``).  The port's scan
against its own
stepwise decode is held to the reference's test's 1e-4, and the scan
against a plain loop in f64 to 1e-6.
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
from repro.models import rglru as jrg
from repro.models import transformer as jtf
from repro_torch.configs import OPTIMIZED, get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import rglru as trg
from repro_torch.models.transformer import (build_model, forward_prefill,
                                            forward_train, init_cache,
                                            init_params, params_from_numpy,
                                            reference_key)
from test_torch_dense import (BF16_TOL, CTX, F32_TOL, batch_for,
                              check_train_against_reference, close, jbatch,
                              leaf, load_module, np_tree, ref_decode,
                              ref_prefill, tbatch, teacher_forcing)

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
GATES = ("gate_r_w", "gate_r_b", "gate_i_w", "gate_i_b")


def perturb_gates(rec: dict, seed: int) -> dict:
    """A (stacked) rec parameter dict with its gates drawn N(0, 1)."""
    rng = np.random.default_rng(seed)
    return dict(rec, **{g: jnp.asarray(rng.normal(size=rec[g].shape),
                                       jnp.float32) for g in GATES})


@functools.lru_cache(maxsize=None)
def ref_params(dtype, seed):
    """The reference's ``init_params`` at SMOKE with perturbed gates, drawn
    once per file.  Callers do not mutate it."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    jp = jax.jit(jtf.init_params, static_argnums=0)(cfg, jax.random.key(seed))
    jp["groups"]["recs"]["rec"] = perturb_gates(jp["groups"]["recs"]["rec"],
                                                seed + 1)
    jp["tail"]["rec"] = perturb_gates(jp["tail"]["rec"], seed + 2)
    return jp


def model_for(dtype="float32", seed=0, **over):
    cfg = get_config(ARCH, smoke=True).replace(attn_q_chunk=8, dtype=dtype,
                                               **over)
    jp = ref_params(dtype, seed)
    return cfg, jp, params_from_numpy(np_tree(jp), cfg, device="cpu")


# ------------------------------------------------------------ config, params
def test_config_and_params_match_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
    full = get_config(ARCH)
    assert full.param_count() == jax_get_config(ARCH).param_count() \
        == 9_572_782_080
    assert OPTIMIZED[ARCH] == JAX_OPTIMIZED[ARCH]
    meta = build_model(full, "meta")
    assert len(meta.groups) == 12 and len(meta.tail) == 2
    jshapes = jax.eval_shape(lambda: jtf.init_params(full,
                                                     jax.random.key(0)))
    want = {"/".join(str(k.key) for k in path): leaf_
            for path, leaf_ in jax.tree_util.tree_leaves_with_path(jshapes)}
    seen = {}
    for name, p in meta.named_parameters():
        key, index = reference_key(name)
        w = want["/".join(key)]
        assert tuple(w.shape[len(index):]) == tuple(p.shape), name
        assert str(w.dtype) == str(p.dtype).replace("torch.", ""), name
        seen.setdefault("/".join(key), set()).add(index)
    assert set(seen) == set(want)
    for k, idx in seen.items():     # every stacked index, once
        assert len(idx) == int(np.prod(want[k].shape[:len(next(iter(idx)))]))


def test_params_from_numpy_and_init_params():
    cfg, jp, model = model_for()
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), leaf(jp, name))
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, 3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    for lyr in [*a.groups[0].recs, *a.tail]:
        rec = lyr.rec.requires_grad_(False)
        assert all((getattr(rec, g) == 0).all() for g in GATES)
        torch.testing.assert_close(rec.lam, torch.linspace(0.3, 1.5,
                                                           cfg.lru_width))
        assert abs(float(rec.conv.std()) / 0.1 - 1) < 0.3
        assert abs(float(rec.w_x.std()) * cfg.d_model ** 0.5 - 1) < 0.15
        assert lyr.mlp.wg is not None          # always SwiGLU


# ------------------------------------------------------------ the block
def _block_setup(dtype, seed=3):
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    jp = perturb_gates(jrg.rglru_layer_init(jax.random.key(seed), cfg,
                                            jnp.dtype(dtype)), seed)
    tp = load_module(trg.RGLRU(cfg, getattr(torch, dtype)), jp)
    return cfg, jp, tp


@pytest.mark.parametrize("carried,dtype", [(False, "float32"),
                                           (True, "float32"),
                                           (True, "bfloat16")])
def test_rglru_block_matches_reference(carried, dtype):
    """Output and state over 13 tokens, from zeros or from a carried state
    (h, and the conv's last 3 inputs), and one decode step after."""
    cfg, jp, tp = _block_setup(dtype)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    B, T, W = 2, 13, cfg.lru_width
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    state = ({"h": rng.normal(size=(B, W)).astype(np.float32),
              "conv": rng.normal(size=(B, 3, W)).astype(np.float32)}
             if carried else None)
    jst = None if state is None else {
        "h": jnp.asarray(state["h"]),
        "conv": jnp.asarray(state["conv"], dtype)}
    tst = None if state is None else {
        "h": torch.from_numpy(state["h"]),
        "conv": torch.from_numpy(state["conv"]).to(dt)}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    yj, sj = jrg.rglru_block(jp, jnp.asarray(x, dtype), cfg, CTX, jst)
    yt, st = trg.rglru_block(tp, torch.from_numpy(x).to(dt), cfg, tst)
    assert yt.dtype == dt and st["h"].dtype == torch.float32
    assert st["conv"].dtype == dt and st["conv"].shape == (B, 3, W)
    close(yt, yj, tol)
    close(st["h"], sj["h"], tol)
    close(st["conv"], sj["conv"], tol)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    yj1, sj1 = jrg.rglru_block(jp, jnp.asarray(x1, dtype), cfg, CTX, sj)
    yt1, st1 = trg.rglru_block(tp, torch.from_numpy(x1).to(dt), cfg, st)
    close(yt1, yj1, tol)
    close(st1["h"], sj1["h"], tol)


@pytest.mark.parametrize("T", [2, 5, 12, 16, 33])
def test_scan_matches_stepwise(T):
    """``tests/test_models.py``'s check on the port: the block over T
    tokens at once (the doubling scan) against T one-token steps."""
    cfg, _, tp = _block_setup("float32")
    x = torch.from_numpy(np.random.default_rng(T).normal(
        size=(2, T, cfg.d_model)).astype(np.float32))
    y_scan, st_scan = trg.rglru_block(tp, x, cfg)
    st, ys = None, []
    for t in range(T):
        y, st = trg.rglru_block(tp, x[:, t:t + 1], cfg, st)
        ys.append(y)
    torch.testing.assert_close(y_scan, torch.cat(ys, 1), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st_scan["h"], st["h"], rtol=1e-4, atol=1e-4)
    assert torch.equal(st_scan["conv"], st["conv"])


@pytest.mark.parametrize("T", [1, 2, 3, 7, 8, 9, 64, 100])
def test_linear_scan_matches_a_loop(T):
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, size=(3, T, 5)))
    b = torch.from_numpy(rng.normal(size=(3, T, 5)))
    h0 = torch.from_numpy(rng.normal(size=(3, 5)))
    got = trg.linear_scan(a, b, h0)
    h, want = h0, []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("remat", ["none", "nothing", "dots"])
def test_forward_train_matches_reference(remat):
    """Loss and every gradient leaf against ``jax.value_and_grad`` over 24
    tokens, past the local window of 16."""
    cfg, jp, model = model_for(remat_policy=remat)
    b = batch_for(cfg, 2, 24, seed=5, extra=0)
    check_train_against_reference(cfg, jp, model, b)


def _prefill_and_decode(cfg, jp, model, b, S, max_len, tol):
    pre = {"tokens": b["tokens"][:, :S]}
    lj, cj = ref_prefill(jp, jbatch(pre), cfg, max_len)
    lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, max_len)
    close(lt, lj, tol)
    want = init_cache(cfg, 2, max_len, device="cpu")
    assert set(ct) == set(cj) == set(want)
    for name in cj:
        assert ct[name].shape == want[name].shape == cj[name].shape, name
        assert ct[name].dtype == want[name].dtype, name
        close(ct[name], cj[name], tol)
    for t in range(2):      # two steps: the second reads the first's state
        nxt = b["tokens"][:, S + t:S + t + 1]
        lj, cj = ref_decode(jp, cj, jnp.asarray(nxt), cfg)
        lt, ct = make_serve_step(cfg, device="cpu")(model, ct, nxt)
        close(lt, lj, tol)
        for name in cj:
            close(ct[name], cj[name], tol)


@pytest.mark.parametrize("S", [12, 24])
def test_prefill_and_decode_match_reference(S):
    """A prompt within the local window (12 < 16) and one past it (24: the
    ring wraps and keeps the last 16 positions at slot p % 16)."""
    cfg, jp, model = model_for()
    b = batch_for(cfg, 2, S, seed=1, extra=2)
    _prefill_and_decode(cfg, jp, model, b, S, S + 8, F32_TOL)


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def test_prefill_and_decode_match_reference_bf16():
    """In bf16 the recurrence carries each layer's rounding on through the
    prompt, and the two frameworks round at other places, so the two bf16
    runs lie ~2-3% apart, each as far from the f32 run (more than the
    dense family's 2e-2).  So each bf16 output of the port (the prefill's
    logits, two decode steps' logits) is held to the reference's f32 run
    of the same weights: within 1.25 x the reference's own bf16 distance
    from it, in rms over the logits (the factor of chip_smoke.py's bf16
    checks)."""
    S, max_len = 24, 32
    b = batch_for(get_config(ARCH, smoke=True), 2, S, seed=2, extra=2)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg, jp, model = model_for(dtype)
        pre = {"tokens": b["tokens"][:, :S]}
        lj, cj = ref_prefill(jp, jbatch(pre), cfg, max_len)
        lt, ct = make_prefill_step(cfg, device="cpu")(model, pre, max_len)
        out = [(np.asarray(lj), lt.numpy())]
        for t in range(2):
            nxt = b["tokens"][:, S + t:S + t + 1]
            lj, cj = ref_decode(jp, cj, jnp.asarray(nxt), cfg)
            lt, ct = make_serve_step(cfg, device="cpu")(model, ct, nxt)
            out.append((np.asarray(lj), lt.numpy()))
        runs[dtype] = out
        for name in cj:
            assert ct[name].dtype == init_cache(cfg, 2, max_len,
                                                device="cpu")[name].dtype
    for (f32_j, f32_t), (b16_j, b16_t) in zip(runs["float32"],
                                               runs["bfloat16"]):
        close(f32_t, f32_j, F32_TOL)
        assert _rms(b16_t, f32_j) <= 1.25 * _rms(b16_j, f32_j)


@pytest.mark.parametrize("S", [7, 23])
def test_decode_matches_teacher_forcing(S):
    """prefill(S) + decode(token S) equals prefill(S + 1)'s last logits, on
    the port alone; at S = 23 the ring of 16 has wrapped."""
    cfg, _, model = model_for()
    b = batch_for(cfg, 2, S, seed=3)
    step, full = teacher_forcing(cfg, model, b, S, S + 8)
    close(step, full.numpy(), F32_TOL)


def test_cache_holds_only_the_local_window():
    """The rglru_hybrid cache: a ring of min(local_window, max_len) slots
    per group, the recurrent state per layer; prefill of 40 tokens leaves
    the last 16 positions in the ring."""
    cfg, _, model = model_for()
    c = init_cache(cfg, 3, 100, device="cpu")
    assert c["k"].shape == (1, 3, 16, 1, 16)
    assert c["h"].shape == (1, 2, 3, 64) and c["h"].dtype == torch.float32
    assert c["conv"].shape == (1, 2, 3, 3, 64)
    assert c["tail_h"].shape == (1, 3, 64)
    assert init_cache(cfg, 3, 10, device="cpu")["k"].shape[2] == 10
    toks = batch_for(cfg, 1, 40, seed=6, extra=0)["tokens"]
    with torch.no_grad():
        _, cache = forward_prefill(model, tbatch({"tokens": toks}), cfg, 64)
    kpos = cache["kpos"].numpy()
    assert sorted(kpos.tolist()) == list(range(24, 40))
    assert all(kpos[p % 16] == p for p in range(24, 40))


def test_loss_is_finite_and_gradients_flow_in_bf16():
    cfg, _, model = model_for("bfloat16")
    b = tbatch(batch_for(cfg, 2, 24, seed=7, extra=0))
    loss, _ = forward_train(model, b, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)
    lam = dict(zip([n for n, _ in model.named_parameters()], grads))
    assert lam["groups.0.recs.1.rec.lam"].abs().max() > 0
    assert lam["tail.0.rec.gate_i_w"].abs().max() > 0
