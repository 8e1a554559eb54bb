"""Production entry point for fused min-distance + argmin.

Port of ``repro.kernels.pdist.ops``.  ``min_argmin(x, c, metric=...,
policy=KernelPolicy(...))`` dispatches through the backend registry:

  * ``cuda``    — the Hopper kernel (``csrc/pdist.cu``), auto-picked on a
    CUDA tensor for l2sq / l2 / l1,
  * ``blocked`` — chunked plain torch: at most ``block_n × m`` distances
    live at once; for l1 the centers are chunked by 64 to bound the
    (bn, mc, d) broadcast,
  * ``ref``     — the oracle in ``ref.py`` (full (n, m) matrix).

Cosine is served by ``blocked`` / ``ref`` only, on every platform, as in
the reference.  All paths agree with ``ref.min_argmin_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from . import ref as _ref
from .kernel import DTYPE_CODES, min_argmin_cuda, route

_DEFAULT_BLOCK_N = 16384
# the reference's blocked candidates; the cuda kernel's tiles are fixed
# per width, so it registers none (dispatch.py)
_TUNE_BLOCK_NS = (4096, 8192, 16384, 32768, 65536)
_L1_CHUNK = 64


def _block_min_argmin(xb: torch.Tensor, c: torch.Tensor, metric: str):
    """One n-block against all centers; l1 chunks centers by 64."""
    if metric != "l1":
        return _ref.min_argmin_ref(xb, c, metric)
    xb, c = xb.float(), c.float()
    best_d = torch.full((xb.shape[0],), float("inf"), device=xb.device)
    best_i = torch.zeros((xb.shape[0],), dtype=torch.int32, device=xb.device)
    for c0 in range(0, c.shape[0], _L1_CHUNK):
        cc = c[c0:c0 + _L1_CHUNK]
        d = (xb[:, None, :] - cc[None, :, :]).abs().sum(-1)    # (bn, mc)
        a = d.argmin(dim=1)
        dmin = d.gather(1, a[:, None])[:, 0]
        take = dmin < best_d
        best_d = torch.where(take, dmin, best_d)
        best_i = torch.where(take, a.to(torch.int32) + c0, best_i)
    return best_d, best_i


def min_argmin_blocked(x: torch.Tensor, c: torch.Tensor, *,
                       metric: str = "l2sq", block_n: int = _DEFAULT_BLOCK_N):
    """Chunked torch path: at most ``block_n × m`` distances live at once."""
    n = x.shape[0]
    if n <= block_n:
        return _block_min_argmin(x, c, metric)
    parts = [_block_min_argmin(x[i:i + block_n], c, metric)
             for i in range(0, n, block_n)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def min_argmin_reference(x: torch.Tensor, c: torch.Tensor, *,
                         metric: str = "l2sq", block_n: int = 0):
    """Oracle backend; materializes the full (n, m) matrix (block_n unused)."""
    return _ref.min_argmin_ref(x, c, metric)


def min_argmin_cuda_backend(x: torch.Tensor, c: torch.Tensor, *,
                            metric: str = "l2sq", block_n: int = 0):
    """The CUDA kernel (block_n unused: its tiles are fixed per width)."""
    return min_argmin_cuda(x.contiguous(), c.contiguous(), metric=metric)


dispatch.register(
    "min_argmin", "blocked",
    supports=lambda metric, platform, dtype, n, m, d: metric in _ref.METRICS,
    priority=lambda platform: 1,
    default_block_n=lambda platform: _DEFAULT_BLOCK_N,
    tune_candidates=_TUNE_BLOCK_NS,
)(min_argmin_blocked)

dispatch.register(
    "min_argmin", "ref",
    supports=lambda metric, platform, dtype, n, m, d: metric in _ref.METRICS,
    priority=lambda platform: 0,
    default_block_n=lambda platform: _DEFAULT_BLOCK_N,
)(min_argmin_reference)

dispatch.register(
    "min_argmin", "cuda",
    # cosine stays on the plain path, as in the reference
    supports=lambda metric, platform, dtype, n, m, d: (
        metric in _ref.CUDA_METRICS and dtype in DTYPE_CODES),
    priority=lambda platform: 10 if platform == "cuda" else -1,
    default_block_n=lambda platform: 0,
)(min_argmin_cuda_backend)


def min_argmin(x: torch.Tensor, c: torch.Tensor, *, metric: str = "l2sq",
               policy: Optional[KernelPolicy] = None):
    """For each row of ``x`` (n, d): distance to the nearest row of ``c``
    (m, d) and its index. Returns (dist (n,) f32, idx (n,) int32).  Counted
    in ``kernels.pairs`` (``dispatch.count_pairs``) under the CUDA route or
    the backend's name."""
    n, d = x.shape
    m = c.shape[0]
    platform = dispatch.platform_of(x)
    reg, bn = dispatch.resolve("min_argmin", policy, metric=metric, n=n,
                               m=m, d=d, dtype=x.dtype, platform=platform)
    if obs.detail_on():
        dispatch.count_pairs(
            "min_argmin", route(n, m, d, metric)
            if reg.name == "cuda" and platform == "cuda" else reg.name, n, m)
    return reg.impl(x, c, metric=metric, block_n=bn)
