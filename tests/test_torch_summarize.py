"""The port's summarizer registry and weighted Summary-Outliers against the
reference, on the CPU.

Under ``JaxReplaySampler`` (the reference's draws) each summary must give
the reference's row ids, candidate flags and round count; integer-valued
weights must be equal, the ``coreset`` weights within rtol 1e-6 (its float64
sensitivity sums run in another order than numpy's pairwise ones) and the
points bit for bit.  Data: ``_data``'s normal cloud with 30 scattered
outliers (the reference's ``tests/test_summarize.py`` data), with unit or
integer weights.  The ``coreset`` cases and the paper's site path (whose
t >> k case runs Alg. 2) use an integer grid: with float data the XLA-CPU
dot and torch's sum a distance in other orders (ROADMAP.md, queue 3, items
1 and 3), which moves the coreset weights by up to ~1.5e-6 relative and
can flip a ball's edge point.

The registry tests mirror the reference's ``tests/test_summarize.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.summarize as jsum
from repro.stream.weighted import (_min_argmin_bucketed as jax_bucketed,
                                   merge_summaries as jax_merge,
                                   resummarize as jax_resummarize,
                                   weighted_summary_outliers as jax_wso)
from repro_torch.core.sampler import TorchSampler
from repro_torch.core.summary import summary_outliers
from repro_torch.stream.weighted import (_bucket, _min_argmin_bucketed,
                                         categorical_by_weight,
                                         merge_summaries, resummarize,
                                         weighted_summary_outliers)
from repro_torch.summarize import (SummarizerPolicy, get_summarizer,
                                   record_bound, reduce_summaries,
                                   registered_summarizers, select_summarizer,
                                   site_summary, summarize, summarizer_policy,
                                   using_summarizer)
from repro_torch.summarize import base as tbase
from repro_torch.summarize.paper import pick_augmented
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)

NAMES = ("paper", "uniform", "ball_cover", "coreset")
K, T = 8, 25
# the sized baselines at a budget below n, so their draws decide the ids
PARAMS = {"uniform": {"budget": 150}, "coreset": {"budget": 150}}


def _data(n=1200, d=4, seed=0, outliers=30, grid=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if outliers:
        ids = rng.choice(n, outliers, replace=False)
        x[ids] += rng.uniform(-25, 25, size=(outliers, d)).astype(np.float32)
    # integer coordinates: every distance is exact in f32, whatever order
    # a dot product sums in
    return np.round(x * 4) if grid else x


def _weights(kind, n, seed):
    if kind == "unit":
        return np.ones((n,), np.float32)
    # integer weights 0..4: zero-weight rows are dropped, the rest carry
    # exact integer masses
    return np.random.default_rng(seed + 100).integers(0, 5, n).astype(
        np.float32)


def _assert_same(got, want, *, rtol=None):
    """A port WeightedSummary against the reference's (numpy) one."""
    for name in ("indices", "is_candidate"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.points.numpy(), want.points)
    if rtol is None:
        np.testing.assert_array_equal(got.weights.numpy(), want.weights)
    else:
        np.testing.assert_allclose(got.weights.numpy(), want.weights,
                                   rtol=rtol, atol=0)
    assert got.n_rounds == want.n_rounds
    assert got.total_weight == want.total_weight


def _check_protocol(x, w, summ, t):
    """The reference's protocol checks (tests/test_summarize.py)."""
    w = torch.as_tensor(w)
    np.testing.assert_allclose(float(summ.weights.sum()), float(w.sum()),
                               rtol=1e-4)
    assert summ.total_weight == pytest.approx(float(w.sum()), rel=1e-5)
    assert bool((summ.weights > 0).all())
    assert summ.indices is not None and summ.indices.dtype == torch.int64
    np.testing.assert_array_equal(summ.points.numpy(),
                                  np.asarray(x)[summ.indices.numpy()])
    assert float(summ.weights[summ.is_candidate].sum()) <= 8 * t + 1e-3


# --------------------------------------------------------- replay parity
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_weighted_summary_outliers_matches_reference(weights, seed):
    x = _data(seed=seed)
    w = _weights(weights, x.shape[0], seed)
    key = jax.random.key(seed)
    want = jax_wso(x, w, key, k=K, t=T)
    got = weighted_summary_outliers(torch.as_tensor(x), torch.as_tensor(w),
                                    JaxReplaySampler(key), k=K, t=T)
    _assert_same(got, want)
    assert got.n_rounds >= 2                  # the loop really ran


@pytest.mark.parametrize("name", ["uniform", "ball_cover", "coreset"])
@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_registry_summarizer_matches_reference(name, weights):
    seed = 3
    x = _data(seed=seed, grid=name == "coreset")
    w = _weights(weights, x.shape[0], seed)
    key = jax.random.key(seed)
    params = PARAMS.get(name, {})
    want = jsum.summarize(x, w, key, k=K, t=T,
                          policy=jsum.summarizer_policy(name, **params))
    got = summarize(torch.as_tensor(x), torch.as_tensor(w),
                    JaxReplaySampler(key), k=K, t=T,
                    policy=summarizer_policy(name, **params))
    _assert_same(got, want, rtol=1e-6 if name == "coreset" else None)


@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_merge_and_resummarize_match_reference(weights):
    x = _data(seed=4)
    w = _weights(weights, x.shape[0], 4)
    halves = []
    for lo, hi, s in ((0, 600, 5), (600, 1200, 6)):
        key = jax.random.key(s)
        halves.append((jax_wso(x[lo:hi], w[lo:hi], key, k=K, t=T),
                       weighted_summary_outliers(
                           torch.as_tensor(x[lo:hi]),
                           torch.as_tensor(w[lo:hi]), JaxReplaySampler(key),
                           k=K, t=T)))
    want = jax_merge([h[0] for h in halves])
    got = merge_summaries([h[1] for h in halves])
    np.testing.assert_array_equal(got.points.numpy(), want.points)
    np.testing.assert_array_equal(got.weights.numpy(), want.weights)
    np.testing.assert_array_equal(got.is_candidate.numpy(),
                                  want.is_candidate)
    assert got.n_rounds == want.n_rounds and got.indices is None
    assert got.total_weight == want.total_weight
    key = jax.random.key(7)
    want = jax_resummarize([h[0] for h in halves], key, k=K, t=T)
    got = resummarize([h[1] for h in halves], JaxReplaySampler(key), k=K,
                      t=T)
    _assert_same(got, want)


@pytest.mark.parametrize("variant", ["auto", "plain", "augmented"])
@pytest.mark.parametrize("t", [4, 60])
def test_paper_site_path_matches_reference(variant, t):
    # t = 4 < 2k: auto is Alg. 1; t = 60 >= 2k: auto is Alg. 2
    x = _data(n=900, seed=17, grid=True)
    key = jax.random.key(3)
    want = jsum.site_summary(jnp.asarray(x), key, k=K, t=t,
                             policy=jsum.summarizer_policy("paper",
                                                           variant=variant))
    got = site_summary(torch.as_tensor(x), JaxReplaySampler(key), k=K, t=t,
                       policy=summarizer_policy("paper", variant=variant))
    for name in ("indices", "weights", "is_candidate", "valid", "sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.n_rounds == int(want.n_rounds)


def test_site_summary_plain_is_summary_outliers_bitwise():
    x = torch.as_tensor(_data(n=900, seed=17))
    via = site_summary(x, TorchSampler(3), k=K, t=T,
                       policy=summarizer_policy("paper", variant="plain"))
    direct = summary_outliers(x, TorchSampler(3), k=K, t=T)
    assert torch.equal(via.points, direct.points)
    assert torch.equal(via.weights, direct.weights)


# ------------------------------------------------------ plain versions
@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_min_argmin_unpadded_equals_padded_call(n, grid):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    c = rng.normal(size=(13, 5)).astype(np.float32)
    if grid:
        x, c = np.round(x * 4), np.round(c * 4)
    want_d, want_a = jax_bucketed(x, c, metric="l2sq", policy=None)
    # the reference's padded call on the port's own min_argmin
    xp = np.concatenate([x, np.full((_bucket(n) - n, 5), 1e30, np.float32)])
    pad_d, pad_a = _min_argmin_bucketed(torch.as_tensor(xp),
                                        torch.as_tensor(c), metric="l2sq",
                                        policy=None)
    got_d, got_a = _min_argmin_bucketed(torch.as_tensor(x),
                                        torch.as_tensor(c), metric="l2sq",
                                        policy=None)
    assert torch.equal(got_a, pad_a[:n])
    if grid:
        assert torch.equal(got_d, pad_d[:n])
    else:
        # the CPU matmul picks its blocking by shape, so with float data a
        # row's dot product may round otherwise at another row count
        np.testing.assert_allclose(got_d.numpy(), pad_d[:n].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), want_a)


def test_categorical_by_weight_pads_logits_like_the_reference():
    seen = []

    class Spy(JaxReplaySampler):
        def categorical(self, logits, shape=()):
            seen.append(logits.clone())
            return super().categorical(logits, shape)

    w = np.arange(1, 301, dtype=np.float32)
    key = jax.random.key(9)
    ids = categorical_by_weight(Spy(key), torch.as_tensor(w), (40,))
    assert seen[0].shape == (512,) and bool(torch.isinf(seen[0][300:]).all())
    from repro.stream.weighted import categorical_by_weight as jax_cat
    np.testing.assert_array_equal(ids.numpy(), jax_cat(key, w, (40,)))


@pytest.mark.parametrize("name", NAMES)
def test_torch_sampler_conserves_mass_and_reproduces(name):
    x = torch.as_tensor(_data(seed=8))
    w = torch.as_tensor(_weights("integer", x.shape[0], 8))
    pol = summarizer_policy(name, **PARAMS.get(name, {}))
    a = summarize(x, w, TorchSampler(5), k=K, t=T, policy=pol)
    _check_protocol(x, w, a, T)
    b = summarize(x, w, TorchSampler(5), k=K, t=T, policy=pol)
    for f in ("points", "weights", "is_candidate", "indices"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c = summarize(x, w, TorchSampler(6), k=K, t=T, policy=pol)
    assert not torch.equal(a.indices, c.indices)     # another seed differs


# ------------------------------------------ registry (tests/test_summarize.py)
def test_registry_contents():
    assert set(NAMES) <= set(registered_summarizers())
    assert set(registered_summarizers()) == set(jsum.registered_summarizers())
    with pytest.raises(ValueError, match="unknown summarizer"):
        get_summarizer("nope")
    with pytest.raises(ValueError, match="unknown summarizer"):
        summarize(np.zeros((4, 2)), np.ones(4), TorchSampler(0), k=2, t=1,
                  policy=SummarizerPolicy("nope"), device="cpu")
    for name in NAMES:
        mine, ref = get_summarizer(name), jsum.get_summarizer(name)
        assert (mine.priority, mine.sized, mine.site_summary is None) == \
            (ref.priority, ref.sized, ref.site_summary is None)


def test_auto_selects_paper_and_never_a_baseline():
    for metric in ("l2sq", "l2", "l1", "cosine"):
        spec = select_summarizer(SummarizerPolicy("auto"), metric=metric,
                                 k=K, t=T)
        assert spec.name == "paper"
    assert get_summarizer("uniform").priority < 0  # by-name only


def test_policy_params_are_canonical_and_hashable():
    a = summarizer_policy("coreset", budget=64, seed_rounds=2)
    b = SummarizerPolicy("coreset", {"seed_rounds": 2, "budget": 64})
    assert a == b and hash(a) == hash(b)
    assert a.with_params(budget=128).params_dict()["budget"] == 128
    assert a.params_dict() == {"budget": 64, "seed_rounds": 2}


@pytest.mark.parametrize("weights", ["unit", "weighted"])
@pytest.mark.parametrize("name", NAMES)
def test_protocol_conserves_mass(name, weights):
    x = _data(seed=2)
    if weights == "unit":
        w = np.ones((x.shape[0],), np.float32)
    else:
        rng = np.random.default_rng(3)
        w = rng.uniform(0.25, 4.0, size=(x.shape[0],)).astype(np.float32)
        w[rng.choice(x.shape[0], 50, replace=False)] = 0.0  # dropped rows
    summ = summarize(x, w, TorchSampler(2), k=K, t=T,
                     policy=SummarizerPolicy(name), device="cpu")
    _check_protocol(x, w, summ, T)
    if weights == "unit":
        assert int(summ.is_candidate.sum()) <= 8 * T


@pytest.mark.parametrize("name", NAMES)
def test_merge_then_reduce_composes(name):
    pol = SummarizerPolicy(name)
    x1, x2 = _data(seed=4), _data(seed=5)
    w = np.ones((x1.shape[0],), np.float32)
    s1 = summarize(x1, w, TorchSampler(3), k=K, t=T, policy=pol,
                   device="cpu")
    s2 = summarize(x2, w, TorchSampler(4), k=K, t=T, policy=pol,
                   device="cpu")
    red = reduce_summaries([s1, s2], TorchSampler(5), k=K, t=T, policy=pol)
    np.testing.assert_allclose(float(red.weights.sum()),
                               x1.shape[0] + x2.shape[0], rtol=1e-4)
    cap = record_bound(pol, k=K, t=T, max_points=x1.shape[0] + x2.shape[0],
                       leaf_size=x1.shape[0])
    assert red.points.shape[0] <= cap
    assert float(red.weights[red.is_candidate].sum()) <= 8 * T + 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_empty_and_degenerate_inputs(name):
    pol = SummarizerPolicy(name)
    s = summarize(np.zeros((0, 3), np.float32), np.zeros((0,), np.float32),
                  TorchSampler(0), k=K, t=T, policy=pol, device="cpu")
    assert s.points.shape == (0, 3) and s.total_weight == 0.0
    one = summarize(np.ones((1, 3), np.float32), np.ones((1,), np.float32),
                    TorchSampler(0), k=K, t=T, policy=pol, device="cpu")
    assert float(one.weights.sum()) == pytest.approx(1.0)
    # every weight zero: nothing to summarize
    z = summarize(np.ones((5, 3), np.float32), np.zeros((5,), np.float32),
                  TorchSampler(0), k=K, t=T, policy=pol, device="cpu")
    assert z.points.shape[0] == 0
    empty = reduce_summaries([s], TorchSampler(0), k=K, t=T, policy=pol)
    assert empty.points.shape[0] == 0


def test_default_summarize_is_weighted_summary_outliers_bitwise():
    x = torch.as_tensor(_data(seed=6))
    w = torch.ones((x.shape[0],))
    via = summarize(x, w, TorchSampler(7), k=K, t=T)
    direct = weighted_summary_outliers(x, w, TorchSampler(7), k=K, t=T)
    for f in ("points", "weights", "is_candidate", "indices"):
        assert torch.equal(getattr(via, f), getattr(direct, f)), f


def test_default_reduce_is_resummarize_bitwise():
    x = torch.as_tensor(_data(seed=7))
    w = torch.ones((x.shape[0],))
    s1 = weighted_summary_outliers(x[:600], w[:600], TorchSampler(8), k=K,
                                   t=T)
    s2 = weighted_summary_outliers(x[600:], w[600:], TorchSampler(9), k=K,
                                   t=T)
    a = reduce_summaries([s1, s2], TorchSampler(10), k=K, t=T)
    b = resummarize([s1, s2], TorchSampler(10), k=K, t=T)
    assert torch.equal(a.points, b.points)
    assert torch.equal(a.weights, b.weights)


def test_process_default_summarizer_threading():
    x = torch.as_tensor(_data(seed=16))
    w = torch.ones((x.shape[0],))
    pol = summarizer_policy("uniform", budget=96)
    with using_summarizer(pol):
        assert tbase.get_default_summarizer() == pol
        s = summarize(x, w, TorchSampler(1), k=K, t=T)
    assert tbase.get_default_summarizer() == SummarizerPolicy()
    assert s.points.shape[0] <= 96 and not bool(s.is_candidate.any())


def test_explicit_summarizer_that_cannot_serve_raises(monkeypatch):
    spec = get_summarizer("paper")._replace(
        name="no_l1", supports=lambda metric, k, t: metric != "l1")
    monkeypatch.setitem(tbase._REGISTRY, "no_l1", spec)
    pol = SummarizerPolicy("no_l1")
    assert select_summarizer(pol, metric="l2sq", k=K, t=T).name == "no_l1"
    with pytest.raises(ValueError, match="does not support"):
        summarize(_data(n=50), np.ones(50), TorchSampler(0), k=K, t=T,
                  metric="l1", policy=pol, device="cpu")
    # auto never falls back to a summarizer that cannot serve
    assert select_summarizer(None, metric="l1", k=K, t=T).name == "paper"


@pytest.mark.parametrize("name", ["ball_cover", "coreset"])
def test_site_summary_host_only_raises(name):
    with pytest.raises(ValueError, match="no fixed-shape site path"):
        site_summary(torch.zeros((64, 3)), TorchSampler(0), k=2, t=2,
                     policy=SummarizerPolicy(name))


@pytest.mark.parametrize("entry", ["summarize", "site_summary",
                                   "weighted_summary_outliers"])
def test_array_input_refuses_cuda_without_a_card(entry):
    """An array has no device of its own: it goes to ``device``, which
    defaults to the card and raises when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, w = _data(n=64), np.ones(64, np.float32)
    call = {"summarize": lambda: summarize(x, w, TorchSampler(0), k=K, t=T),
            "site_summary": lambda: site_summary(x, TorchSampler(0), k=K,
                                                 t=T),
            "weighted_summary_outliers": lambda: weighted_summary_outliers(
                x, w, TorchSampler(0), k=K, t=T)}[entry]
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        call()


def test_paper_variant_auto_rule():
    assert pick_augmented("auto", k=10, t=100, metric="l2sq")
    assert not pick_augmented("auto", k=10, t=5, metric="l2sq")
    assert not pick_augmented("auto", k=10, t=100, metric="cosine")
    assert pick_augmented("augmented", k=10, t=1, metric="l2sq")
    assert not pick_augmented("plain", k=10, t=100, metric="l2sq")
    with pytest.raises(ValueError, match="variant"):
        pick_augmented("bogus", k=10, t=1, metric="l2sq")


@pytest.mark.parametrize("name", NAMES)
def test_record_bound_equals_reference(name):
    for params in ({}, {"budget": 300}):
        for k in (1, 3, 20):
            for t in (1, 25, 400):
                for max_points in (10, 5_000, 4_898_431):
                    for leaf_size in (64, 2_048):
                        kw = dict(k=k, t=t, max_points=max_points,
                                  leaf_size=leaf_size)
                        assert record_bound(
                            summarizer_policy(name, **params), **kw) == \
                            jsum.record_bound(
                                jsum.summarizer_policy(name, **params), **kw)


def test_coreset_serves_cosine():
    x = _data(n=2000, d=6, seed=19)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    w = np.ones((x.shape[0],), np.float32)
    summ = summarize(x, w, TorchSampler(4), k=10, t=60, metric="cosine",
                     policy=summarizer_policy("coreset", budget=512),
                     device="cpu")
    _check_protocol(x, w, summ, 60)
    assert summ.points.shape[0] <= 512
