"""Production entry point for the fused serving score op.

Port of ``repro.kernels.score.ops``.  ``score(x, c, threshold, metric=...,
policy=KernelPolicy(...))`` computes, in one dispatch, the distance to the
nearest center, the winning center index, and the outlier score
``dist / max(threshold, 1e-30)``.  Returns ``(dist (n,), idx (n,) int32,
score (n,))``.

Backends:

  * ``ref``     — composed oracle: ``min_argmin_ref`` + divide,
  * ``blocked`` — rows tiled by ``block_n``, centers by ``block_m`` with a
    running (min, argmin) across center tiles; when the centers fit one
    tile (the serving case) it is the ref computation, bit for bit,
  * ``cuda``    — one Hopper kernel (``csrc/score.cu``), auto-picked on the
    card for l2sq / l2 / l1,
  * ``int8``    — quantized-center variant (per-center symmetric scale,
    rescaled to f32, then the blocked pass): it changes results, so it is
    never auto-picked.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.pdist import ref as _ref
from repro_torch.kernels.pdist.kernel import DTYPE_CODES
from repro_torch.kernels.score.kernel import score_cuda

_DEFAULT_BLOCK_N = 16384
_TUNE_BLOCK_NS = (4096, 8192, 16384, 32768, 65536)
_DEFAULT_BLOCK_M = 128
_TUNE_BLOCK_MS = (64, 128, 256, 512)
_EPS = 1e-30  # threshold guard — matches the reference's serving divide


def _score_args(n: int, m: int, d: int, rng: np.random.Generator):
    """The autotuner's operands (the reference's): score takes a
    threshold, pdist doesn't."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((m, d)).astype(np.float32)
    return (x, c, np.float32(1.0))


def _finish(dist: torch.Tensor, amin: torch.Tensor, threshold):
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=dist.device)
    return dist, amin, dist / torch.clamp(thr, min=_EPS)


def _tile_min_argmin(xb: torch.Tensor, c: torch.Tensor, metric: str,
                     block_m: int):
    """One row block against all centers, center-tiled by ``block_m``;
    strict ``<`` across tiles keeps the earliest tile on ties.  The ragged
    last tile is sliced, not padded, so there is no padded column to mask
    (the reference pads it and masks it with +inf: the same result)."""
    m = c.shape[0]
    if m <= block_m:
        return _ref.min_argmin_ref(xb, c, metric)
    best_d = torch.full((xb.shape[0],), float("inf"), device=xb.device)
    best_i = torch.zeros((xb.shape[0],), dtype=torch.int32, device=xb.device)
    for c0 in range(0, m, block_m):
        dmin, darg = _ref.min_argmin_ref(xb, c[c0:c0 + block_m], metric)
        take = dmin < best_d
        best_d = torch.where(take, dmin, best_d)
        best_i = torch.where(take, darg + c0, best_i)
    return best_d, best_i


def _score_rows(x, c, threshold, metric, block_n, block_m):
    """Shared blocked compute (float centers in, used by blocked + int8)."""
    parts = [_tile_min_argmin(x[i:i + block_n], c, metric, block_m)
             for i in range(0, max(x.shape[0], 1), block_n)]
    if len(parts) == 1:
        dist, amin = parts[0]
    else:
        dist = torch.cat([p[0] for p in parts])
        amin = torch.cat([p[1] for p in parts])
    return _finish(dist, amin, threshold)


def score_reference(x, c, threshold, *, metric: str = "l2sq",
                    block_n: int = 0, block_m: int = 0):
    """Oracle: the composed three-step path as one function (tiles unused)."""
    dist, amin = _ref.min_argmin_ref(x, c, metric)
    return _finish(dist, amin, threshold)


def score_blocked(x, c, threshold, *, metric: str = "l2sq",
                  block_n: int = _DEFAULT_BLOCK_N,
                  block_m: int = _DEFAULT_BLOCK_M):
    """Chunked single pass; ≤ ``block_n × block_m`` distances live at once."""
    return _score_rows(x, c, threshold, metric, block_n, block_m)


def score_int8(x, c, threshold, *, metric: str = "l2sq",
               block_n: int = _DEFAULT_BLOCK_N,
               block_m: int = _DEFAULT_BLOCK_M):
    """Quantized-center score: ``scale_i = max|c_i| / 127`` per center row,
    centers rounded to int8 (half to even, as ``jnp.round``) and rescaled
    to f32, then the blocked pass.  Plain torch, opt-in only.

    As in the reference, the scale and the quotient are computed in c's
    own dtype (bf16 centers quantize on bf16's grid), and the cast
    saturates: a quotient that rounds to 128 becomes 127, where torch's
    cast would wrap it to -128."""
    scale = torch.clamp(c.abs().amax(dim=1) / 127.0, min=1e-12)
    cq = torch.round(c / scale[:, None]).clamp(-128, 127).to(torch.int8)
    cdq = cq.to(torch.float32) * scale[:, None].float()
    return _score_rows(x, cdq, threshold, metric, block_n, block_m)


def score_cuda_backend(x, c, threshold, *, metric: str = "l2sq",
                       block_n: int = 0, block_m: int = 0):
    """The CUDA kernel (launch shape from n and d; block_n/block_m unused).
    A threshold that is not yet a float32 tensor on x's device is made one;
    the serving model's already is, and passes as it is."""
    if not (isinstance(threshold, torch.Tensor)
            and threshold.dtype == torch.float32
            and threshold.device == x.device):
        threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                    device=x.device)
    return score_cuda(x.contiguous(), c.contiguous(), threshold,
                      metric=metric)


def _register(name, fn, supports, priority, tuned=False):
    """``tuned``: the reference's blocked (block_n, block_m) candidates."""
    dispatch.register(
        "score", name, supports=supports, priority=priority,
        default_block_n=lambda platform: _DEFAULT_BLOCK_N,
        tune_candidates=_TUNE_BLOCK_NS if tuned else (),
        make_args=_score_args,
        default_block_m=lambda platform: _DEFAULT_BLOCK_M,
        tune_candidates_m=_TUNE_BLOCK_MS if tuned else ())(fn)


_any_metric = (lambda metric, platform, dtype, n, m, d:
               metric in _ref.METRICS)
_register("ref", score_reference, _any_metric, lambda platform: 0)
_register("blocked", score_blocked, _any_metric, lambda platform: 1,
          tuned=True)
# changes results (quantization error): explicit opt-in only
_register("int8", score_int8, _any_metric, lambda platform: -1, tuned=True)
# cosine stays on the plain path, matching pdist; launch shape from n and
# d, so no tile candidates
_register("cuda", score_cuda_backend,
          lambda metric, platform, dtype, n, m, d: (
              metric in _ref.CUDA_METRICS and dtype in DTYPE_CODES),
          lambda platform: 10 if platform == "cuda" else -1)


def score(x: torch.Tensor, c: torch.Tensor, threshold, *,
          metric: str = "l2sq", policy: Optional[KernelPolicy] = None):
    """Fused serving score: one dispatch for pdist → argmin → dist/thr.

    Returns ``(dist (n,), idx (n,) int32, score (n,))``; ``score > 1`` is
    the paper's outlier predicate.
    """
    n, d = x.shape
    reg, bn, bm = dispatch.resolve_tiles("score", policy, metric=metric, n=n,
                                         m=c.shape[0], d=d, dtype=x.dtype,
                                         platform=dispatch.platform_of(x))
    return reg.impl(x, c, threshold, metric=metric, block_n=bn, block_m=bm)
