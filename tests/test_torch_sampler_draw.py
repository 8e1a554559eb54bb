"""The port's categorical draw (``TorchSampler.categorical``): inverse CDF on
the logits' device, with uniforms from the sampler's own CPU generator.

Every case of the draw runs on the CPU and, marked ``chip``, on a CUDA card;
without one those skip (on a card: ``python -m pytest
tests/test_torch_sampler_draw.py -m chip``).  The card's own cases hold its
ids to the CPU's and check that a draw never waits for the device.  The
other draws (``randint``, ``uniform``, ``choice``) and the sampler's words
are held to values they gave before the categorical draw moved to the
device.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.core.sampler import TorchSampler

NINF = float("-inf")
# 12 entries, -inf leading, inside and trailing
WEIGHTED = [NINF, 0.3, -1.2, NINF, 2.0, 0.0, -0.5, 1.1, NINF, -2.5, 0.7, NINF]
FINITE = np.isfinite(WEIGHTED)


@pytest.fixture
def card():
    """The CUDA card, or a skip where the machine has none (the cases that
    use it are marked ``chip``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.chip)])
def dev(request):
    """The CPU, and a CUDA card where the machine has one."""
    if request.param == "cpu":
        return torch.device("cpu")
    return request.getfixturevalue("card")


def _masked(n, seed, share=0.4):
    """0 / -inf logits of length n, ``share`` of them -inf (the first and
    last entries among them)."""
    g = np.random.default_rng(seed)
    lg = np.where(g.random(n) < share, -np.inf, 0.0)
    lg[0] = lg[-1] = -np.inf
    return torch.as_tensor(lg, dtype=torch.float32)


def _weighted(n, seed):
    """Logits log(w) of random weights, -inf where w is 0 (a fifth)."""
    g = np.random.default_rng(seed)
    w = g.exponential(size=n) * (g.random(n) > 0.2)
    with np.errstate(divide="ignore"):
        return torch.as_tensor(np.log(w), dtype=torch.float32)


def test_frequencies_follow_softmax(dev):
    count = 200_000
    ids = TorchSampler(1234).categorical(torch.tensor(WEIGHTED, device=dev),
                                         (count,))
    seen = torch.bincount(ids.cpu(), minlength=len(WEIGHTED)).numpy()
    assert seen[~FINITE].sum() == 0
    p = torch.softmax(torch.tensor(WEIGHTED, dtype=torch.float64), 0)
    test = stats.chisquare(seen[FINITE], p.numpy()[FINITE] * count)
    assert test.pvalue > 1e-3, test


@pytest.mark.parametrize("where", [0, 5, 11])
def test_a_single_finite_entry_is_the_only_id(dev, where):
    logits = torch.full((12,), NINF, device=dev)
    logits[where] = 3.0
    ids = TorchSampler(where).categorical(logits, (1000,))
    assert torch.all(ids == where)


@pytest.mark.parametrize("seed", range(4))
def test_minus_inf_is_never_drawn(dev, seed):
    for logits in (_masked(5000, seed), _weighted(5000, seed)):
        ids = TorchSampler(seed).categorical(logits.to(dev), (20_000,))
        assert torch.isfinite(logits[ids.cpu()]).all()


def test_zero_entries_have_no_width_under_a_scan_that_is_not_sequential(
        dev, monkeypatch):
    # a card's scan adds in another order than the CPU's: let every zero
    # entry's prefix sum come out far too large, and nothing else change
    real = torch.cumsum

    def skewed(x, dim, **kw):
        out = real(x, dim, **kw)
        if out.dtype == torch.float64:
            out = out + torch.where(x == 0, 0.5, 0.0)
        return out

    monkeypatch.setattr(torch, "cumsum", skewed)
    ids = TorchSampler(5).categorical(torch.tensor(WEIGHTED, device=dev),
                                      (20_000,))
    assert FINITE[ids.cpu().numpy()].all()


@pytest.mark.parametrize("bits,want", [(0, 1), (2 ** 53 - 1, 10)])
def test_the_ends_of_the_uniforms_draw_the_first_and_last_finite_entries(
        dev, monkeypatch, bits, want):
    # the uniforms 0 and 1 - 2**-53: the least and the most 53 random bits
    monkeypatch.setattr(torch.Tensor, "random_",
                        lambda self, *a, **kw: self.fill_(bits))
    ids = TorchSampler(0).categorical(torch.tensor(WEIGHTED, device=dev),
                                      (8,))
    assert ids.tolist() == [want] * 8


def test_all_minus_inf_gives_an_id_in_range_without_raising(dev):
    ids = TorchSampler(3).categorical(torch.full((7,), NINF, device=dev),
                                      (5,))
    assert ids.dtype == torch.int64 and ((ids >= 0) & (ids < 7)).all()


@pytest.mark.parametrize("shape", [(), (9,), (3, 4)])
def test_ids_are_int64_of_the_shape_on_the_logits_device(dev, shape):
    ids = TorchSampler(11).categorical(torch.tensor(WEIGHTED, device=dev),
                                       shape)
    assert ids.shape == shape and ids.dtype == torch.int64
    assert ids.device == dev


def test_float32_and_float64_logits_draw_the_same_ids(dev):
    lg = _weighted(3000, 9).to(dev)
    s = TorchSampler(21)
    assert torch.equal(s.categorical(lg, (500,)),
                       s.categorical(lg.double(), (500,)))


def test_a_sampler_is_a_value(dev):
    lg = _weighted(3000, 10).to(dev)
    s = TorchSampler(22).fold_in(4).split(3)[2]
    first = s.categorical(lg, (500,))
    assert torch.equal(first, s.categorical(lg, (500,)))
    again = TorchSampler.from_key_data(s.key_data())
    assert torch.equal(first, again.categorical(lg, (500,)))
    assert not torch.equal(first, s.fold_in(1).categorical(lg, (500,)))


def test_the_other_draws_are_as_before():
    s = TorchSampler(2024).fold_in(3).split(2)[1]
    assert s.key_data().tolist() == [2298149490, 1684983116]
    assert s.randint(1000, (6,)).tolist() == [881, 670, 992, 395, 134, 370]
    np.testing.assert_array_equal(
        s.uniform((4,), -1.0, 2.0).numpy(),
        np.array([1.7055037021636963, 1.133199691772461, 0.4657306671142578,
                  1.174191951751709], np.float32))
    assert s.choice(50, (5,)).tolist() == [31, 24, 2, 6, 1]
    assert s.choice(50, (5,), replace=True).tolist() == [31, 20, 42, 45, 34]


@pytest.mark.chip
def test_card_and_cpu_draw_identical_ids_for_zero_and_minus_inf(card):
    key = TorchSampler(77)
    for seed, (n, count) in enumerate([(244_922, 26), (250_000, 200),
                                       (244_922, 364_321)]):
        key, sk = key.split(2)
        lg = _masked(n, seed)
        assert torch.equal(sk.categorical(lg, (count,)),
                           sk.categorical(lg.to(card), (count,)).cpu())


@pytest.mark.chip
def test_card_and_cpu_agree_for_weighted_logits(card):
    lg = _weighted(151_960, 5)
    s = TorchSampler(78)
    cpu = s.categorical(lg, (200_000,))
    gpu = s.categorical(lg.to(card), (200_000,)).cpu()
    assert (cpu == gpu).double().mean() >= 0.9999
    # one pick a sampler, as k-means++ draws
    picks = [TorchSampler(79).fold_in(i) for i in range(200)]
    same = sum(int(p.categorical(lg)) == int(p.categorical(lg.to(card)))
               for p in picks)
    assert same >= 199


@pytest.mark.chip
def test_a_card_draw_never_waits_for_the_card(card):
    logits = [_masked(244_922, 1).to(card), _weighted(151_960, 2).to(card)]
    s = TorchSampler(80)
    s.categorical(logits[0], (26,))          # the card and its context up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = [s.fold_in(i).categorical(lg, shape)
               for i, (lg, shape) in enumerate(
                   (lg, shape) for lg in logits
                   for shape in [(), (26,), (364_321,), (3, 5)])]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(o.device.type == "cuda" for o in out)
