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
``sampler.rows{caller}`` counters; otherwise it costs that one check.

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


def _drawn(caller: Optional[str], rows: int, draw, *args):
    """``draw(*args)`` inside a ``sampler.draw`` span, counted."""
    caller = caller or "other"
    with obs.span("sampler.draw", caller=caller, rows=rows):
        out = draw(*args)
    reg = obs.get_default_registry()
    reg.counter("sampler.draws", caller=caller).inc()
    reg.counter("sampler.rows", caller=caller).inc(rows)
    return out


class Sampler(abc.ABC):
    """Key-like source of random draws (see module docstring)."""

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
                      logits, shape)

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
    ``s`` draws.  A draw's generator is seeded from the words.  Draws are
    made by a CPU generator and the ids moved to the logits' device, so a
    run's draws do not depend on whether it ran on the card.
    """

    _SPLIT, _FOLD = 1, 2

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
        lg = logits.detach().to("cpu", torch.float64)
        probs = torch.softmax(lg, dim=0)
        count = math.prod(shape) if len(shape) else 1
        ids = torch.multinomial(probs, count, replacement=True,
                                generator=self._generator())
        return ids.reshape(tuple(shape)).to(logits.device)

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
