"""The one seam every random draw of the port goes through.

The reference threads a ``jax.random`` key through its algorithms; JAX's
threefry and torch's Philox give different numbers from the same seed, so
the port passes a :class:`Sampler` wherever the reference passes its key,
and calls it in the reference's key schedule:

  * ``split`` once per round (``summary.py``), ``split(3)`` in Alg. 2
    (after ``fold_in(17)`` on the compact path), ``split`` per k-means++
    pick;
  * ``fold_in(i)`` per site and ``fold_in(2**31 - 1)`` for the second level
    (``distributed.py``);
  * ``uniform`` for the ``uniform`` summarizer's reservoir keys and
    ``choice(replace=False)`` for the ``rand`` baseline's sample.

A test-side adapter that maps the same four methods onto ``jax.random``
therefore replays the reference's draws exactly; production uses
:class:`TorchSampler`.  A sampler is a value, like a key: drawing from the
same sampler twice gives the same numbers.

Every ``categorical`` and ``randint`` draw, whatever the sampler, goes
through :class:`Sampler`'s own methods, which call the subclass's
``_categorical`` / ``_randint`` (:class:`TorchSampler`'s ``choice`` with
replacement is such a ``randint``).  While
a ``torch.profiler`` records (``obs.detail_on()``) the draw is an ``obs``
span ``sampler.draw`` (``caller``: the call site's name; ``rows``: the
logits' length, or ``high`` for ``randint``, the rows the draw chooses
among) and adds to the ``sampler.draws{caller}`` and
``sampler.rows{caller}`` counters, and a ``categorical`` whose ids were
made on a CUDA device (:attr:`Sampler.draws_on_device`) to
``sampler.card_draws{caller}``; otherwise it costs that one check.

:class:`TorchSampler` draws ``categorical`` ids on the logits' device by
inverse CDF, with uniforms from its own CPU generator (its docstring says
how far the ids depend on the device); ``randint``, ``uniform`` and
``choice`` are drawn on the CPU and moved.

A sampler packs into two uint32 words (``key_data``), the shape of the
reference's ``jax.random.key_data`` leaf, so the stream tree and service
checkpoint it as a fixed-shape leaf; the restore paths take a
``sampler_from_key_data`` hook that rebuilds a sampler from those words
(:meth:`TorchSampler.from_key_data` by default).
"""
from __future__ import annotations

import abc
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs


def _drawn(caller: Optional[str], rows: int, draw, *args,
           card: bool = False):
    """``draw(*args)`` inside a ``sampler.draw`` span, counted; ``card``:
    the draw makes its ids on a CUDA device."""
    caller = caller or "other"
    with obs.span("sampler.draw", caller=caller, rows=rows):
        out = draw(*args)
    reg = obs.get_default_registry()
    reg.counter("sampler.draws", caller=caller).inc()
    reg.counter("sampler.rows", caller=caller).inc(rows)
    if card:
        reg.counter("sampler.card_draws", caller=caller).inc()
    return out


class Sampler(abc.ABC):
    """Key-like source of random draws (see module docstring)."""

    #: ``_categorical`` makes its ids on the logits' device (else it draws
    #: elsewhere and moves them there)
    draws_on_device = False

    @abc.abstractmethod
    def key_data(self) -> np.ndarray:
        """The sampler's state as ``(2,)`` uint32 words
        (``jax.random.key_data``); a checkpoint stores them."""

    @abc.abstractmethod
    def split(self, n: int = 2) -> list["Sampler"]:
        """``n`` independent child samplers (``jax.random.split``)."""

    @abc.abstractmethod
    def fold_in(self, i: int) -> "Sampler":
        """A child sampler derived from the integer ``i``
        (``jax.random.fold_in``)."""

    def categorical(self, logits: torch.Tensor, shape: Sequence[int] = (),
                    *, caller: Optional[str] = None) -> torch.Tensor:
        """int64 ids of ``shape`` drawn with replacement with probability
        ``softmax(logits)``; ``-inf`` entries are never drawn
        (``jax.random.categorical``).  On ``logits``' device.  ``caller``
        names the draw in its span and counters (module docstring)."""
        if not obs.detail_on():
            return self._categorical(logits, shape)
        return _drawn(caller, int(logits.shape[-1]), self._categorical,
                      logits, shape,
                      card=self.draws_on_device and logits.is_cuda)

    def randint(self, high: int, shape: Sequence[int], device=None, *,
                caller: Optional[str] = None) -> torch.Tensor:
        """int64 ids of ``shape``, uniform in ``[0, high)``
        (``jax.random.randint(key, shape, 0, high)``); ``caller`` as for
        :meth:`categorical`."""
        if not obs.detail_on():
            return self._randint(high, shape, device)
        return _drawn(caller, int(high), self._randint, high, shape, device)

    @abc.abstractmethod
    def _categorical(self, logits: torch.Tensor,
                     shape: Sequence[int]) -> torch.Tensor:
        """:meth:`categorical`'s draw."""

    @abc.abstractmethod
    def _randint(self, high: int, shape: Sequence[int],
                 device=None) -> torch.Tensor:
        """:meth:`randint`'s draw."""

    @abc.abstractmethod
    def uniform(self, shape: Sequence[int], minval: float, maxval: float,
                device=None) -> torch.Tensor:
        """float32 of ``shape``, uniform in ``[minval, maxval)``
        (``jax.random.uniform(key, shape, minval=, maxval=)``)."""

    @abc.abstractmethod
    def choice(self, n: int, shape: Sequence[int], replace: bool = False,
               device=None) -> torch.Tensor:
        """int64 ids of ``shape`` drawn from ``[0, n)``, distinct unless
        ``replace`` (``jax.random.choice(key, n, shape, replace=)``)."""


class TorchSampler(Sampler):
    """Production sampler over ``torch.Generator``.

    A value identified by two uint32 words.  ``TorchSampler(seed)`` derives
    them from the seed, and ``split`` / ``fold_in`` derive each child's
    words from the parent's words and (tag, index) through numpy's
    ``SeedSequence``, so the state stays two words however long the chain
    of splits: ``TorchSampler.from_key_data(s.key_data())`` draws what
    ``s`` draws.  A draw's generator is a CPU generator seeded from the
    words.

    ``categorical`` draws by inverse CDF on the logits' device:
    ``p = exp(logits - max)`` and its prefix sums in float64 there, ``count``
    uniforms in [0, 1) of 53 bits from the CPU generator (copied from
    pinned memory, without waiting, on a card), and each id found by
    ``searchsorted`` of its uniform times the total.  An entry of zero
    probability (``-inf``) has an interval of no width, so it is never
    drawn; nothing waits for the device.  The uniforms are the same on every
    device, so:

    * for logits of 0 and ``-inf`` (Algorithm 1's rounds, Algorithm 2's
      extra centers) the prefix sums are whole numbers below 2**53, exact,
      and the CPU and a card draw identical ids;
    * for weighted logits (the k-means++ picks, k-means||, the stream's
      weighted rounds) they draw the same ids except where a uniform falls
      within float64 rounding of an interval's end.

    ``randint``, ``uniform`` and ``choice`` are drawn by the CPU generator
    and moved to ``device``, so they do not depend on it at all.
    """

    _SPLIT, _FOLD = 1, 2
    draws_on_device = True

    def __init__(self, seed: int):
        words = np.random.SeedSequence(int(seed)).generate_state(2, np.uint32)
        self._words = (int(words[0]), int(words[1]))

    @classmethod
    def from_key_data(cls, words) -> "TorchSampler":
        """The sampler whose :meth:`key_data` is ``words``."""
        words = np.asarray(words, np.uint32).reshape(-1)
        if words.shape != (2,):
            raise ValueError(f"key data must be 2 uint32 words, got "
                             f"shape {words.shape}")
        sampler = cls.__new__(cls)
        sampler._words = (int(words[0]), int(words[1]))
        return sampler

    def key_data(self) -> np.ndarray:
        return np.asarray(self._words, np.uint32)

    def __repr__(self) -> str:
        return f"TorchSampler(words={self._words})"

    def _child(self, tag: int, i: int) -> "TorchSampler":
        ss = np.random.SeedSequence(entropy=list(self._words),
                                    spawn_key=(tag, int(i)))
        return TorchSampler.from_key_data(ss.generate_state(2, np.uint32))

    def split(self, n: int = 2) -> list["TorchSampler"]:
        return [self._child(self._SPLIT, j) for j in range(n)]

    def fold_in(self, i: int) -> "TorchSampler":
        return self._child(self._FOLD, i)

    def _generator(self) -> torch.Generator:
        g = torch.Generator(device="cpu")
        g.manual_seed((self._words[0] << 32) | self._words[1])
        return g

    def _categorical(self, logits, shape):
        lg = logits.detach().to(torch.float64)
        p = torch.exp(lg - lg.max())
        n = p.numel()
        # Each entry takes the prefix sum of the last entry of nonzero
        # probability up to it: positive entries scatter their sums to their
        # rank and every entry reads its rank's, so a zero entry's interval
        # has no width whatever order the scan adds in (a card's is not
        # sequential).
        pos = p > 0
        rank = torch.cumsum(pos, 0)
        at = torch.zeros((n + 2,), dtype=torch.float64, device=lg.device)
        at.scatter_(0, torch.where(pos, rank, n + 1), torch.cumsum(p, 0))
        cdf = at[rank]
        # a uniform in [0, 1) an id, as 53 random bits from the CPU generator
        # (times 2**-53), copied over without waiting
        count = math.prod(shape) if len(shape) else 1
        bits = torch.empty((count,), dtype=torch.int64, pin_memory=lg.is_cuda)
        bits = bits.random_(0, 2 ** 53, generator=self._generator())
        bits = bits.to(lg.device, non_blocking=True)
        ids = torch.searchsorted(cdf, bits * (cdf[-1] * 2.0 ** -53),
                                 right=True)
        # the last entry of nonzero probability: where every entry is -inf
        # (the caller's error) the total is 0 and the search finds no entry
        last = torch.searchsorted(cdf, cdf[-1:])
        return torch.minimum(ids, last).reshape(tuple(shape))

    def _randint(self, high, shape, device=None):
        ids = torch.randint(0, int(high), tuple(shape),
                            generator=self._generator())
        return ids if device is None else ids.to(device)

    def uniform(self, shape, minval, maxval, device=None):
        u = torch.rand(tuple(shape), generator=self._generator())
        u = torch.clamp(u * (maxval - minval) + minval, min=minval)
        return u if device is None else u.to(device)

    def choice(self, n, shape, replace=False, device=None):
        count = math.prod(shape) if len(shape) else 1
        if replace:
            return self.randint(n, shape, device)
        if count > n:
            raise ValueError(f"cannot take {count} distinct ids of {n}")
        ids = torch.randperm(int(n), generator=self._generator())[:count]
        ids = ids.reshape(tuple(shape))
        return ids if device is None else ids.to(device)
