"""Summarizer registry: pluggable summary construction for every layer.

Port of ``repro.summarize.base``.  It is the summarize-layer twin of
``repro_torch.kernels.dispatch``:

* a **registry** of summarizers, each registered under a name with a
  capability predicate over (metric, k, t) and an auto-selection priority;
* one **``SummarizerPolicy``** frozen dataclass ``(name, params)`` — the
  single object threaded through ``core/distributed.py`` and the smoke
  run's head-to-head, or installed process-wide with
  ``set_default_summarizer``;
* a uniform **protocol**: weighted points in, mass-conserving
  ``repro_torch.stream.weighted.WeightedSummary`` out.  Mass conservation
  is the contract that makes every implementation compose with
  merge-and-reduce and with Algorithm 3's second level (the union's total
  weight equals ``n``).

Registered implementations (see the sibling modules): ``paper``
(Algorithm 1 / 2 / the weighted generalization; the auto default),
``uniform`` (weighted reservoir sample, the paper's ``rand`` baseline
generalized), ``ball_cover`` (heavy-noise aggregation) and ``coreset``
(k-means||-seeded sensitivity sampling, any metric).

An explicit summarizer that cannot serve a call **raises**: summarizers are
different algorithms with different outputs, so a silent substitution would
change results (unlike the kernel registry's backends, which compute one
function).  Draws go through a :class:`~repro_torch.core.sampler.Sampler`
where the reference passes a key.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, TYPE_CHECKING

import numpy as np
import torch

from repro_torch import resolve_device

if TYPE_CHECKING:  # the implementation modules import this one
    from repro_torch.core.summary import Summary
    from repro_torch.stream.weighted import WeightedSummary


@dataclasses.dataclass(frozen=True)
class SummarizerPolicy:
    """The one summary-algorithm selection object threaded through layers.

    name    — "auto" (pick the best-supported registered summarizer for
              this (metric, k, t)), or an explicit registry name.
    params  — algorithm parameters as a sorted tuple of (key, value) pairs
              so the policy stays hashable (dicts are accepted and
              canonicalized).  Use :func:`summarizer_policy` for keyword
              ergonomics: ``summarizer_policy("coreset", budget=512)``.
    """

    name: str = "auto"
    params: tuple = ()

    def __post_init__(self):
        p = self.params
        if isinstance(p, dict):
            p = p.items()
        object.__setattr__(self, "params", tuple(sorted(tuple(p))))

    def params_dict(self) -> dict:
        return dict(self.params)

    def with_params(self, **updates) -> "SummarizerPolicy":
        merged = {**self.params_dict(), **updates}
        return SummarizerPolicy(self.name, tuple(sorted(merged.items())))


def summarizer_policy(name: str = "auto", **params) -> SummarizerPolicy:
    """Keyword-friendly constructor: ``summarizer_policy("uniform", budget=256)``."""
    return SummarizerPolicy(name, tuple(sorted(params.items())))


class SummarizerSpec(NamedTuple):
    """One registered summary algorithm.

    summarize     — (points, weights, sampler, *, k, t, alpha, beta, metric,
                    kernel_policy, device, **params) -> WeightedSummary.
                    Set logic in torch on the device :func:`as_points`
                    picks, mass conserving, ``indices`` populated with
                    input-row ids.
    site_summary  — optional fixed-shape unit-weight path
                    (x, sampler, *, k, t, alpha, beta, metric,
                    kernel_policy, **params) -> core.summary.Summary — the
                    per-site program of the reference's
                    ``distributed_cluster``.  None when the algorithm has
                    only the weighted path.
    supports      — (metric, k, t) -> bool capability predicate.
    priority      — auto-selection priority; < 0 means never auto-picked
                    (baselines you must ask for by name).
    record_bound  — (params, *, k, t, alpha, beta, max_points, leaf_size)
                    -> int static per-summary record capacity (the stream
                    tree's checkpoint packing).
    sized         — True when the algorithm accepts an external ``budget``
                    param (reservoir/coreset style), so a comparison can
                    size-match it to the paper summary.
    """

    name: str
    summarize: Callable
    supports: Callable
    priority: int
    record_bound: Callable
    description: str
    site_summary: Optional[Callable] = None
    sized: bool = False


_REGISTRY: dict[str, SummarizerSpec] = {}
_default_policy = SummarizerPolicy()
_registered = False


def _ensure_registered() -> None:
    """Import the implementation modules so they land in the registry."""
    global _registered
    if _registered:
        return
    _registered = True
    from repro_torch.summarize import ball_cover as _bc    # noqa: F401
    from repro_torch.summarize import coreset as _cs       # noqa: F401
    from repro_torch.summarize import paper as _paper      # noqa: F401
    from repro_torch.summarize import uniform as _uni      # noqa: F401


def register_summarizer(
    name: str,
    *,
    summarize: Callable,
    supports: Callable,
    priority: int,
    record_bound: Callable,
    description: str,
    site_summary: Optional[Callable] = None,
    sized: bool = False,
) -> SummarizerSpec:
    spec = SummarizerSpec(name=name, summarize=summarize, supports=supports,
                          priority=priority, record_bound=record_bound,
                          description=description, site_summary=site_summary,
                          sized=sized)
    _REGISTRY[name] = spec
    return spec


def registered_summarizers() -> dict[str, SummarizerSpec]:
    _ensure_registered()
    return dict(_REGISTRY)


def get_summarizer(name: str) -> SummarizerSpec:
    _ensure_registered()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown summarizer {name!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    return spec


# --------------------------------------------------------------- policy state
def get_default_summarizer() -> SummarizerPolicy:
    return _default_policy


def set_default_summarizer(policy: SummarizerPolicy) -> SummarizerPolicy:
    """Install ``policy`` process-wide; returns the previous default."""
    global _default_policy
    prev = _default_policy
    _default_policy = policy
    return prev


@contextlib.contextmanager
def using_summarizer(policy: SummarizerPolicy):
    """Context manager: scoped :func:`set_default_summarizer`."""
    prev = set_default_summarizer(policy)
    try:
        yield policy
    finally:
        set_default_summarizer(prev)


def resolve_summarizer(policy: Optional[SummarizerPolicy]) -> SummarizerPolicy:
    return policy if policy is not None else get_default_summarizer()


def select_summarizer(
    policy: Optional[SummarizerPolicy] = None,
    *,
    metric: str,
    k: int,
    t: int,
) -> SummarizerSpec:
    """Pick the spec serving this call under ``policy``.

    Explicit names raise when unsupported (a different summarizer is a
    different algorithm, not an interchangeable implementation).
    """
    policy = resolve_summarizer(policy)
    _ensure_registered()
    if policy.name != "auto":
        spec = get_summarizer(policy.name)
        if not spec.supports(metric, k, t):
            raise ValueError(
                f"summarizer {policy.name!r} does not support "
                f"metric={metric!r} (k={k}, t={t})")
        return spec
    candidates = [s for s in _REGISTRY.values()
                  if s.priority >= 0 and s.supports(metric, k, t)]
    if not candidates:
        raise ValueError(
            f"no registered summarizer supports metric={metric!r} "
            f"(k={k}, t={t})")
    return max(candidates, key=lambda s: s.priority)


# ----------------------------------------------------------------- entry points
def summarize(
    points,
    weights,
    sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[SummarizerPolicy] = None,
    kernel_policy=None,
    device="cuda",
) -> "WeightedSummary":
    """Weighted records in -> mass-conserving ``WeightedSummary`` out, on
    the device of ``points`` when it is a tensor, else on ``device``.

    ``policy`` selects the algorithm, ``kernel_policy`` the distance
    backend.
    """
    policy = resolve_summarizer(policy)
    spec = select_summarizer(policy, metric=metric, k=k, t=t)
    return spec.summarize(points, weights, sampler, k=k, t=t, alpha=alpha,
                          beta=beta, metric=metric,
                          kernel_policy=kernel_policy, device=device,
                          **policy.params_dict())


def reduce_summaries(
    summaries: Sequence["WeightedSummary"],
    sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[SummarizerPolicy] = None,
    kernel_policy=None,
) -> "WeightedSummary":
    """Merge (concatenate; lossless) then re-summarize under ``policy``.

    The registry-dispatched generalization of
    ``repro_torch.stream.weighted.resummarize``; with the default policy it
    is that function, bit for bit.
    """
    from repro_torch.stream.weighted import merge_summaries

    merged = merge_summaries(summaries)
    if merged.points.shape[0] == 0:
        return merged
    return summarize(merged.points, merged.weights, sampler, k=k, t=t,
                     alpha=alpha, beta=beta, metric=metric, policy=policy,
                     kernel_policy=kernel_policy)


def site_summary(
    x,
    sampler,
    *,
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    metric: str = "l2sq",
    policy: Optional[SummarizerPolicy] = None,
    kernel_policy=None,
    device="cuda",
) -> "Summary":
    """Fixed-shape unit-weight site path, on the device of ``x`` when it is
    a tensor, else on ``device``.

    Raises for summarizers without one; those run through
    ``simulate_coordinator``'s weighted path instead.
    """
    policy = resolve_summarizer(policy)
    spec = select_summarizer(policy, metric=metric, k=k, t=t)
    if spec.site_summary is None:
        raise ValueError(
            f"summarizer {spec.name!r} has no fixed-shape site path "
            f"(host-driven only); use simulate_coordinator or the weighted "
            f"summarize() entry point")
    return spec.site_summary(as_points(x, device), sampler, k=k, t=t, alpha=alpha, beta=beta,
                             metric=metric, kernel_policy=kernel_policy,
                             **policy.params_dict())


def record_bound(
    policy: Optional[SummarizerPolicy] = None,
    *,
    metric: str = "l2sq",
    k: int,
    t: int,
    alpha: float = 2.0,
    beta: float = 0.45,
    max_points: int,
    leaf_size: int,
) -> int:
    """Static per-summary record capacity under ``policy`` (tree packing)."""
    policy = resolve_summarizer(policy)
    spec = select_summarizer(policy, metric=metric, k=k, t=t)
    return int(spec.record_bound(policy.params_dict(), k=k, t=t, alpha=alpha,
                                 beta=beta, max_points=max_points,
                                 leaf_size=leaf_size))


# ------------------------------------------------------------- shared helpers
def as_points(points, device="cuda") -> torch.Tensor:
    """``points`` as an f32 tensor: a tensor stays on its own device, an
    array goes to ``resolve_device(device)`` (which raises for a CUDA
    device when no GPU is present)."""
    if isinstance(points, torch.Tensor):
        return points.float()
    return torch.as_tensor(np.asarray(points, np.float32),
                           device=resolve_device(device))


def clean_weighted_input(points, weights, device="cuda"):
    """Canonicalize a weighted record set for the weighted summarizers.

    Returns ``(x (n,d) f32, w (n,) f32, orig_ids (n,) int64, total float)``
    on the device :func:`as_points` picks, with zero-weight rows dropped;
    ``orig_ids`` maps kept rows back to the caller's row numbering so
    ``WeightedSummary.indices`` stays meaningful.
    """
    x = as_points(points, device)
    w = torch.as_tensor(weights).to(x.device, torch.float32).reshape(-1)
    if x.dim() != 2 or x.shape[0] != w.shape[0]:
        raise ValueError(f"points {tuple(x.shape)} / weights "
                         f"{tuple(w.shape)} mismatch")
    keep = w > 0
    orig = torch.nonzero(keep).flatten()
    x, w = x[keep], w[keep]
    return x, w, orig, float(w.sum())


def empty_summary(d: int, device=None) -> "WeightedSummary":
    from repro_torch.stream.weighted import WeightedSummary

    return WeightedSummary(
        points=torch.zeros((0, d), dtype=torch.float32, device=device),
        weights=torch.zeros((0,), dtype=torch.float32, device=device),
        is_candidate=torch.zeros((0,), dtype=torch.bool, device=device),
        n_rounds=0, total_weight=0.0,
        indices=torch.zeros((0,), dtype=torch.int64, device=device))
