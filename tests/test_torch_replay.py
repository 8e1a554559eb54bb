"""The replay sampler: the port's ``Sampler`` seam driven by ``jax.random``.

``JaxReplaySampler`` maps ``split`` / ``fold_in`` / ``categorical`` /
``randint`` / ``uniform`` / ``choice`` / ``key_data`` onto the reference's
``jax.random`` calls (``categorical`` and ``randint`` through the seam's
own methods, as every sampler's draws go), so a port function
given it draws exactly the numbers the reference draws from the same key.
The sibling ``test_torch_*`` files import it from here
(``from test_torch_replay import JaxReplaySampler``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.core.sampler import Sampler, TorchSampler

torch.set_num_threads(1)


class JaxReplaySampler(Sampler):
    """Test-side adapter: a ``jax.random`` key behind the port's seam."""

    def __init__(self, key):
        self.key = key

    @classmethod
    def from_key_data(cls, words):
        """The restore paths' ``sampler_from_key_data`` hook."""
        return cls(jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32)))

    def key_data(self):
        return np.asarray(jax.random.key_data(self.key))

    def split(self, n: int = 2):
        keys = jax.random.split(self.key, n)
        return [JaxReplaySampler(keys[i]) for i in range(n)]

    def fold_in(self, i: int):
        return JaxReplaySampler(jax.random.fold_in(self.key, i))

    def _categorical(self, logits, shape):
        lg = jnp.asarray(logits.detach().cpu().float().numpy())
        ids = jax.random.categorical(self.key, lg,
                                     shape=tuple(shape) if shape else None)
        return torch.as_tensor(np.asarray(ids, np.int64)).to(logits.device)

    def _randint(self, high, shape, device=None):
        ids = jax.random.randint(self.key, tuple(shape), 0, int(high))
        out = torch.as_tensor(np.asarray(ids, np.int64))
        return out if device is None else out.to(device)

    def uniform(self, shape, minval, maxval, device=None):
        u = jax.random.uniform(self.key, tuple(shape), minval=minval,
                               maxval=maxval)
        out = torch.as_tensor(np.array(u, np.float32))
        return out if device is None else out.to(device)

    def choice(self, n, shape, replace=False, device=None):
        ids = jax.random.choice(self.key, int(n), tuple(shape),
                                replace=replace)
        out = torch.as_tensor(np.asarray(ids, np.int64))
        return out if device is None else out.to(device)


def test_replay_reproduces_jax_draws():
    key = jax.random.key(3)
    smp = JaxReplaySampler(key)
    # split / fold_in follow jax's key tree
    k_a, k_b = jax.random.split(key)
    s_a, s_b = smp.split(2)
    logits = np.where(np.arange(50) % 3 == 0, 0.0, -np.inf).astype(np.float32)
    want = jax.random.categorical(k_b, jnp.asarray(logits), shape=(17,))
    got = s_b.categorical(torch.as_tensor(logits), (17,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() % 3 == 0).all()          # -inf never drawn
    # scalar categorical (the k-means++ pick)
    want = jax.random.categorical(k_a, jnp.asarray(logits))
    got = s_a.categorical(torch.as_tensor(logits))
    assert got.shape == () and int(got) == int(want)
    kf = jax.random.fold_in(key, 2**31 - 1)
    want = jax.random.randint(kf, (9,), 0, 1000)
    got = smp.fold_in(2**31 - 1).randint(1000, (9,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 17), 3)
    t1, t2, t3 = smp.fold_in(17).split(3)
    np.testing.assert_array_equal(
        t3.randint(7, (5,)).numpy(),
        np.asarray(jax.random.randint(k3, (5,), 0, 7)))


@pytest.mark.parametrize("draw", ["uniform", "choice"])
def test_replay_reproduces_jax_uniform_and_choice(draw):
    key = jax.random.key(5)
    smp = JaxReplaySampler(key).fold_in(3).split(2)[1]
    k = jax.random.split(jax.random.fold_in(key, 3))[1]
    if draw == "uniform":
        want = jax.random.uniform(k, (1000,), minval=1e-12, maxval=1.0)
        got = smp.uniform((1000,), 1e-12, 1.0)
        assert got.dtype == torch.float32
    else:
        want = jax.random.choice(k, 500, (37,), replace=True)
        np.testing.assert_array_equal(smp.choice(500, (37,), replace=True),
                                      np.asarray(want))
        want = jax.random.choice(k, 500, (37,), replace=False)
        got = smp.choice(500, (37,))
        assert got.dtype == torch.int64
        assert np.unique(got.numpy()).size == 37        # distinct
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_sampler_deterministic_and_masked(seed):
    smp = TorchSampler(seed)
    logits = torch.where(torch.arange(100) % 4 == 1, 0.0, float("-inf"))
    a = smp.fold_in(5).split(2)[1].categorical(logits, (64,))
    b = TorchSampler(seed).fold_in(5).split(2)[1].categorical(logits, (64,))
    assert torch.equal(a, b)                     # a sampler is a value
    assert (a % 4 == 1).all()                    # -inf never drawn
    c = smp.fold_in(6).split(2)[1].categorical(logits, (64,))
    assert not torch.equal(a, c)                 # siblings differ
    r = smp.randint(10, (1000,))
    assert r.min() >= 0 and r.max() < 10 and r.dtype == torch.int64
    assert torch.equal(r, TorchSampler(seed).randint(10, (1000,)))
    u = smp.fold_in(1).uniform((1000,), 1e-12, 1.0)
    assert u.dtype == torch.float32 and u.min() >= 1e-12 and u.max() < 1.0
    assert torch.equal(u, TorchSampler(seed).fold_in(1).uniform(
        (1000,), 1e-12, 1.0))
    c = smp.fold_in(2).choice(100, (100,))
    assert torch.equal(torch.sort(c).values, torch.arange(100))  # distinct
    assert torch.equal(c, TorchSampler(seed).fold_in(2).choice(100, (100,)))


def test_port_imports_neither_jax_nor_the_reference():
    """The port (and its GPU smoke run) must start on a machine that has no
    JAX: no ``jax`` import and nothing of ``repro``, not even numpy-only
    modules."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 15
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert offenders == []
