"""Straggler detection — the paper's own primitive, turned inward.  Port of
``repro.runtime.straggler``.

Per-site step durations are a 1-D clustering-with-outliers problem: the
healthy sites form one tight cluster, stragglers are the outliers.  We run
the paper's pipeline with k=1: summarize the duration history, then
(1,t)-means on it — sites repeatedly flagged become candidates for
re-dispatch (random repartition of their data, the paper's random-partition
model) or drop (the outlier budget t of the *clustering job itself* absorbs
the lost site's points — an option unique to clustering-with-outliers).

An EWMA fallback path is provided for the first few steps where the history
is too short to cluster.  The (1, t)-means runs on ``device`` through the
port's ``kmeans_minus_minus``; its seeding draws from ``sampler`` (default
``TorchSampler(0)``, where the reference uses ``jax.random.key(0)``).
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.sampler import Sampler, TorchSampler


@dataclass
class StragglerMonitor:
    n_sites: int
    window: int = 32
    budget_frac: float = 0.1       # max fraction of sites flagged per step
    ewma_alpha: float = 0.2
    threshold: float = 2.0         # EWMA fallback: flag at 2x smoothed mean
    history: dict = field(default_factory=lambda: defaultdict(lambda: deque(maxlen=64)))
    _ewma: float | None = None
    sampler: Sampler = field(default_factory=lambda: TorchSampler(0))
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def observe(self, durations: np.ndarray) -> np.ndarray:
        """durations: (n_sites,) seconds for the last step.
        Returns boolean straggler mask (n_sites,)."""
        durations = np.asarray(durations, np.float32)
        for i, d in enumerate(durations):
            self.history[i].append(float(d))
        mean = float(durations.mean())
        self._ewma = mean if self._ewma is None else \
            self.ewma_alpha * mean + (1 - self.ewma_alpha) * self._ewma

        n_hist = min(len(self.history[i]) for i in range(self.n_sites))
        if n_hist < 4:
            return durations > self.threshold * self._ewma

        # (1, t)-means on per-site mean durations: outliers = stragglers
        t = max(1, int(self.budget_frac * self.n_sites))
        pts = np.array([[np.mean(self.history[i])] for i in range(self.n_sites)],
                       np.float32)
        dev = self.device
        sol = kmeans_minus_minus(
            torch.as_tensor(pts, device=dev),
            torch.ones((self.n_sites,), dtype=torch.float32, device=dev),
            torch.ones((self.n_sites,), dtype=torch.bool, device=dev),
            self.sampler, k=1, t=float(t), iters=8)
        out = sol.outlier.cpu().numpy()
        # only call someone a straggler if they are SLOW outliers AND
        # meaningfully far from the healthy cluster (k-means-- always labels
        # the farthest budget-mass as outliers; significance-gate it)
        center = float(sol.centers[0, 0])
        inlier_std = float(pts[~out, 0].std()) if (~out).any() else 0.0
        gate = center + max(4.0 * inlier_std, 0.25 * center)
        return out & (pts[:, 0] > gate)

    def policy(self, mask: np.ndarray) -> dict:
        """Suggested mitigation per flagged site."""
        return {int(i): ("redispatch" if np.mean(self.history[i]) <
                         3.0 * (self._ewma or 1.0) else "drop")
                for i in np.nonzero(mask)[0]}
