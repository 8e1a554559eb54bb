"""The system under test: the port's Algorithm 3 entries, called as the
paper's tables call them.

The configuration's ``"entry"`` names a file of ``bench/entries``, which
builds the fit over the rows resident on the card with a
``TorchSampler`` seeded per fit.  An entry may also declare ``LIBRARIES``,
the ``kernels/csrc`` libraries its fit launches, and ``warm(device, d)``,
one call of each op its fit launches; the runner builds and loads them
before the warm fits (``runner.build_kernels``).

An answer is what the judge reads: record ids (global, -1 padded),
weights, candidate flags where the entry returns them, centers, outlier
ids, cost, the records sent, and the fit's own phase times
(``phase_s``).
"""
from __future__ import annotations

import torch

from bench.harness.spec import load_named


def fit_seed(seed: int, i: int) -> int:
    """The sampler seed of fit ``i`` of a run with ``seed``; the warm-up
    fits take negative ``i``."""
    return (int(seed) << 20) + (i % (1 << 20))


def entry(cfg: dict):
    """The configuration's entry, ``bench/entries/<cfg["entry"]>.py``."""
    return load_named("entries", cfg["entry"])


def make_fit(cfg: dict, x: torch.Tensor, device):
    """A callable ``fit(sampler_seed) -> answer`` for the configuration's
    entry over rows ``x`` (on ``device``): the entry's ``make_fit(cfg, x,
    device)``, which reads from ``cfg`` the keys it needs.  The device work
    of a fit is finished when it returns."""
    return entry(cfg).make_fit(cfg, x, device)


def algorithm3_kwargs(cfg: dict, device) -> dict:
    """The keywords of an Algorithm 3 entry of the port
    (``simulate_coordinator``, ``distributed_cluster``) from the
    configuration: k, t, partition, summary algorithm, Lloyd iterations
    and metric."""
    return dict(k=int(cfg["k"]), t=int(cfg["t"]),
                partition=cfg["partition"], summary_alg=cfg["summary_alg"],
                second_iters=int(cfg["second_iters"]),
                metric=cfg["metric"], device=device)


def to_host(ans: dict) -> dict:
    """The answer with every tensor as numpy (a float for a scalar)."""
    out = {}
    for key, v in ans.items():
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy() if v.dim() else float(v)
        out[key] = v
    return out


def records(ans: dict) -> int:
    """Records the fit sent to the coordinator, counted by the benchmark
    from the answer's valid ids."""
    return int((ans["summary_ids"] >= 0).sum())
