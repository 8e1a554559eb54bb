"""The oneshot engine's two steps, as library functions.

Port of ``repro.api.session._run_oneshot`` (host-simulated branch) and
``_model_from_result``.  They take the pipeline settings as keywords
(``k, t, sites, partition, metric, second_iters, seed, policy,
summarizer``), standing
in for ``PipelineConfig`` until ``api/config.py`` and ``Session`` are
ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distributed import simulate_coordinator
from repro_torch.core.sampler import Sampler, TorchSampler
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.stream.service import ModelState
from repro_torch.summarize.base import SummarizerPolicy

RESULT_KEYS = ("centers", "outlier_ids", "summary_ids", "summary_weights",
               "comm_records", "cost")


def _run_oneshot(x, *, k: int, t: int, sites: int, partition: str = "random",
                 metric: str = "l2sq", second_iters: int = 25, seed: int = 0,
                 policy: Optional[KernelPolicy] = None,
                 summarizer: Optional[SummarizerPolicy] = None,
                 device="cuda", sampler: Optional[Sampler] = None) -> dict:
    """Algorithm 3 over ``x`` split into ``sites`` contiguous parts
    (``np.array_split`` sizes), keyed by ``TorchSampler(seed)`` unless a
    ``sampler`` is given; ``summarizer`` picks each site's summary from the
    registry (None: the paper's Alg. 2).  Returns the reference's six
    result keys plus the port's ``summary_candidates``, ``site_records``,
    ``site_rounds`` and ``phase_s``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    parts = torch.tensor_split(x, sites)
    res = simulate_coordinator(
        parts, sampler if sampler is not None else TorchSampler(seed),
        k=k, t=t, partition=partition, summarizer=summarizer,
        second_iters=second_iters, metric=metric, policy=policy, device=dev)
    return {key: res[key] for key in
            RESULT_KEYS + ("summary_candidates", "site_records",
                           "site_rounds", "phase_s")}


def _model_from_result(x, res: dict, *, metric: str = "l2sq",
                       policy: Optional[KernelPolicy] = None,
                       version: int = 1, device="cuda") -> ModelState:
    """Serving model from a coordinator result — the threshold is the
    largest inlier distance among the summary records the second level was
    fit on, as in ``stream.service.fit_model``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    centers = torch.as_tensor(res["centers"], dtype=torch.float32,
                              device=dev).contiguous()
    ids = torch.as_tensor(np.asarray(res["summary_ids"], np.int64),
                          device=dev)
    dist, _ = min_argmin(x[ids], centers, metric=metric, policy=policy)
    inlier = ~np.isin(res["summary_ids"], res["outlier_ids"])
    dist = dist.cpu().numpy()
    threshold = float(dist[inlier].max()) if inlier.any() else 0.0

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return ModelState(
        centers=centers,
        threshold=scalar(np.float32(max(threshold, 1e-12)), torch.float32),
        cost=scalar(np.float32(res["cost"]), torch.float32),
        version=scalar(version, torch.int32),
        trained_weight=scalar(np.float32(x.shape[0]), torch.float32))
