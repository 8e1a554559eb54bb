"""Data curation for LM training — the paper's technique as a first-class
framework feature (DESIGN §3.1).  Port of ``repro.core.curation``.

Each data-parallel shard is a "site".  Sequence embeddings (mean-pooled
final hidden states, stop-grad) accumulate into a per-site reservoir; every
`detect_every` observations the site builds a Summary-Outliers summary of
its reservoir (Algorithm 1 with t' = 2t/s), summaries are gathered, and the
replicated second-level k-means-- labels the global outlier sequences.
Flagged sequence ids feed back into the sampler as weights (drop or
down-weight).  One round of communication per detection — Algorithm 3
verbatim, with sites = DP shards.

The host-side API (observe/detect) is deliberately synchronous-free: it
runs off the training step on the host using the embeddings the step
already computed, so it adds zero device-step latency.  The reservoirs are
the reference's numpy ones, so both packages keep the same rows;
``detect`` runs ``simulate_coordinator`` on ``device``, its draws from
``sampler`` (default ``TorchSampler(cfg.seed)``, where the reference uses
``jax.random.key(cfg.seed)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distributed import simulate_coordinator
from repro_torch.core.sampler import Sampler, TorchSampler


@dataclass
class CuratorConfig:
    k: int = 16                 # embedding clusters
    outlier_frac: float = 0.01  # t = frac * observed
    reservoir: int = 4096       # per-site reservoir capacity
    min_points: int = 256       # don't cluster before this many
    seed: int = 0


@dataclass
class DataCurator:
    n_sites: int
    cfg: CuratorConfig = field(default_factory=CuratorConfig)
    _buf: list = field(default_factory=list)      # per-site lists
    _ids: list = field(default_factory=list)
    _seen: int = 0
    sampler: Sampler | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._buf = [[] for _ in range(self.n_sites)]
        self._ids = [[] for _ in range(self.n_sites)]
        self._rng = np.random.default_rng(self.cfg.seed)
        self.device = resolve_device(self.device)
        if self.sampler is None:
            self.sampler = TorchSampler(self.cfg.seed)

    def observe(self, site: int, embeddings: np.ndarray, seq_ids: np.ndarray):
        """Reservoir-sample sequence embeddings for one site."""
        emb = np.asarray(embeddings, np.float32)
        ids = np.asarray(seq_ids)
        buf, bids = self._buf[site], self._ids[site]
        for e, i in zip(emb, ids):
            self._seen += 1
            if len(buf) < self.cfg.reservoir:
                buf.append(e), bids.append(i)
            else:
                j = self._rng.integers(0, self._seen)
                if j < self.cfg.reservoir:
                    buf[j], bids[j] = e, i

    @property
    def n_points(self) -> int:
        return sum(len(b) for b in self._buf)

    def detect(self):
        """Run Algorithm 3 over the reservoirs.
        Returns (outlier_seq_ids, comm_records) or (None, 0) if too few."""
        n = self.n_points
        if n < self.cfg.min_points:
            return None, 0.0
        t = max(1, int(self.cfg.outlier_frac * n))
        parts = [np.stack(b) for b in self._buf if b]
        id_parts = [np.asarray(i) for i in self._ids if len(i)]
        res = simulate_coordinator(
            parts, self.sampler, k=self.cfg.k, t=t,
            summary_alg="augmented", device=self.device)
        conc = np.concatenate(id_parts)
        flagged = conc[res["outlier_ids"]]
        return flagged, res["comm_records"]

    def sample_weights(self, seq_ids: np.ndarray, flagged) -> np.ndarray:
        """1.0 for clean sequences, 0.0 for flagged ones."""
        if flagged is None:
            return np.ones(len(seq_ids), np.float32)
        bad = np.isin(np.asarray(seq_ids), flagged)
        return (~bad).astype(np.float32)
