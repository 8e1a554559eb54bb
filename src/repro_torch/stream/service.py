"""Serving model and the fused read path.

Port of the model/read-path half of ``repro.stream.service``: the fitted
``ModelState`` (this system's only state: it has no weights), ``fit_model``
(second-level weighted k-means-- on a root -> ModelState), ``_score_batch``
(one fused ``score`` dispatch per micro-batch: pdist → argmin →
dist/threshold) and ``model_from_arrays``, which carries a model fitted by
the reference across.  ``ServingFrontEnd`` / ``StreamService`` are not
ported yet (ROADMAP.md).

Outlier scoring: a request's score is d(x, nearest center) / threshold,
where threshold is the largest inlier distance seen when the model was
fit; score > 1 flags the point as an outlier under the current model.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.kernels.score.ops import score as fused_score


class ModelState(NamedTuple):
    centers: torch.Tensor     # (k, d) f32
    threshold: torch.Tensor   # () f32 — max inlier distance at fit time
    cost: torch.Tensor        # () f32 — weighted second-level objective
    version: torch.Tensor     # () i32 — 0 means "no model yet"
    trained_weight: torch.Tensor  # () f32 — mass the model was fit on


class QueryResult(NamedTuple):
    request_id: int
    center: int              # nearest-center index
    distance: float
    outlier_score: float     # distance / threshold; > 1 -> outlier
    is_outlier: bool
    latency_s: float


def _score_batch(x, centers, threshold, *, metric, policy):
    # one registry dispatch for the whole read path (pdist + argmin +
    # threshold divide); for the non-quantized backends the fused op is
    # bit-identical to the composed min_argmin + divide
    return fused_score(x, centers, threshold, metric=metric, policy=policy)


def fit_model(pts, wts, valid, sampler, version, *, k, t, iters, metric,
              policy, init_centers=None) -> ModelState:
    """Second-level weighted k-means-- on a (padded) root -> ModelState.

    Pure function of its inputs; ``init_centers`` warm-starts the Lloyd
    loop from the previous model's centers (``sampler`` then unused).
    """
    sol = kmeans_minus_minus(
        pts, wts, valid, sampler, k=k, t=float(t), iters=iters,
        metric=metric, policy=policy, init_centers=init_centers)
    inlier = valid & ~sol.outlier
    threshold = torch.where(inlier, sol.distances, float("-inf")).max()
    threshold = torch.clamp(threshold, min=1e-12).to(torch.float32)
    trained = torch.sum(wts * valid).to(torch.float32)
    dev = pts.device
    return ModelState(
        centers=sol.centers, threshold=threshold,
        cost=sol.cost.to(torch.float32),
        version=torch.tensor(version, dtype=torch.int32, device=dev),
        trained_weight=trained)


def model_from_arrays(md: dict, device="cuda") -> ModelState:
    """The port's ``ModelState`` on ``device`` from the dict the reference's
    ``ServingFrontEnd._model_arrays`` produces (``centers``, ``threshold``,
    ``cost``, ``version``, ``trained_weight``; numpy or array-likes)."""
    dev = resolve_device(device)

    def leaf(name, dtype):
        return torch.tensor(np.asarray(md[name]), dtype=dtype, device=dev)

    return ModelState(
        centers=leaf("centers", torch.float32).contiguous(),
        threshold=leaf("threshold", torch.float32),
        cost=leaf("cost", torch.float32),
        version=leaf("version", torch.int32),
        trained_weight=leaf("trained_weight", torch.float32))
