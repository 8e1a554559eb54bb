"""The reference's sampler: the draw the port made on the CPU before its
categorical draws moved to the card, written apart from the port.

It is not the port's sampler.  The port's ``TorchSampler`` now
draws a categorical on the logits' device by inverse CDF; this one still
copies the logits to the host and draws there with ``softmax`` and
``multinomial``.  It stays because the judge replays no draw: the
reference's own fits (``algorithm.fit``: the control, and the plain
reference of ``calibrate.py``) need draws with the right distribution from
the seed, not the port's draws.

A sampler is a value identified by two uint32 words; ``split`` and
``fold_in`` derive a child's words through numpy's ``SeedSequence``; a
draw's generator is a CPU ``torch.Generator`` seeded from the words, and
its ids are moved to the logits' device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Sampler:
    _SPLIT, _FOLD = 1, 2

    def __init__(self, seed: int, _words=None):
        if _words is None:
            w = np.random.SeedSequence(int(seed)).generate_state(2, np.uint32)
            _words = (int(w[0]), int(w[1]))
        self._words = _words

    def _child(self, tag: int, i: int) -> "Sampler":
        ss = np.random.SeedSequence(entropy=list(self._words),
                                    spawn_key=(tag, int(i)))
        w = ss.generate_state(2, np.uint32)
        return Sampler(0, (int(w[0]), int(w[1])))

    def split(self, n: int = 2) -> list:
        return [self._child(self._SPLIT, j) for j in range(n)]

    def fold_in(self, i: int) -> "Sampler":
        return self._child(self._FOLD, i)

    def _generator(self) -> torch.Generator:
        g = torch.Generator(device="cpu")
        g.manual_seed((self._words[0] << 32) | self._words[1])
        return g

    def categorical(self, logits: torch.Tensor, shape=()) -> torch.Tensor:
        """int64 ids of ``shape`` drawn with replacement with probability
        softmax(logits); -inf entries are never drawn."""
        probs = torch.softmax(logits.detach().to("cpu", torch.float64), 0)
        count = math.prod(shape) if len(shape) else 1
        ids = torch.multinomial(probs, count, replacement=True,
                                generator=self._generator())
        return ids.reshape(tuple(shape)).to(logits.device)
