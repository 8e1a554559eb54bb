"""Public wrapper for the fused Lloyd step (assign + weighted accumulate).

Port of ``repro.kernels.lloyd.ops``.  Backends (registered with
``repro_torch.kernels.dispatch``):

  * ``cuda``    — the Hopper kernel pair (``csrc/lloyd.cu``), l2sq / l2,
  * ``blocked`` — the dispatched ``min_argmin`` for the assignment plus a
    one-hot matmul accumulate (any metric).  For l1 on the card the
    assignment is therefore kernel A (``csrc/pdist.cu``),
  * ``ref``     — the plain-torch oracle in ``ref.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.lloyd.kernel import (LLOYD_METRICS, lloyd_plan,
                                              lloyd_step_cuda)
from repro_torch.kernels.lloyd.ref import lloyd_step_ref
from repro_torch.kernels.pdist.kernel import DTYPE_CODES
from repro_torch.kernels.pdist.ops import min_argmin, min_argmin_blocked

_DEFAULT_BLOCK_N = 16384
_TUNE_BLOCK_NS = (4096, 8192, 16384, 32768, 65536)
_METRICS = ("l2sq", "l2", "l1", "cosine")


def _lloyd_args(n: int, m: int, d: int, rng: np.random.Generator):
    """The autotuner's operands (the reference's)."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=(n,)).astype(np.float32)
    c = rng.standard_normal((m, d)).astype(np.float32)
    return (x, w, c)


def accumulate_by_assignment(x, w, amin, k: int):
    """(sums (k,d), counts (k,)) of ``w``-weighted rows grouped by ``amin``.

    A one-hot matmul, as in the reference, and never ``index_add_`` with
    float weights: its CUDA atomics add in a run-dependent order.  The
    matmul runs in full f32 (TF32 is off, see ``repro_torch/__init__``).
    """
    ar = torch.arange(k, dtype=amin.dtype, device=amin.device)
    onehot = (amin[:, None] == ar[None, :]).to(torch.float32) * w[:, None]
    sums = torch.matmul(onehot.T, x.float())
    return sums, onehot.sum(dim=0)


def lloyd_step_blocked(x, w, c, *, metric: str = "l2sq",
                       policy: Optional[KernelPolicy] = None,
                       block_n: int = _DEFAULT_BLOCK_N):
    """Assignment + one-hot matmul accumulate.  Given a ``policy``, the
    assignment is the dispatched ``min_argmin`` under it (kernel A on the
    card, the chunked torch path on the CPU or under ``backend="blocked"``)
    and takes its tile from it; with none, it is the chunked torch path at
    ``block_n`` rows (what the autotuner times, as the reference's blocked
    Lloyd step is)."""
    if policy is None:
        dist, amin = min_argmin_blocked(x, c, metric=metric, block_n=block_n)
    else:
        dist, amin = min_argmin(x, c, metric=metric, policy=policy)
    sums, counts = accumulate_by_assignment(x, w, amin, c.shape[0])
    return sums, counts, amin, dist


def lloyd_step_reference(x, w, c, *, metric: str = "l2sq", block_n: int = 0):
    return lloyd_step_ref(x, w, c, metric)


def lloyd_step_cuda_backend(x, w, c, *, metric: str = "l2sq",
                            block_n: int = 0):
    return lloyd_step_cuda(x.contiguous(), w.float().contiguous(),
                           c.contiguous(), metric=metric)


dispatch.register(
    "lloyd_step", "blocked",
    supports=lambda metric, platform, dtype, n, m, d: metric in _METRICS,
    priority=lambda platform: 1,
    default_block_n=lambda platform: _DEFAULT_BLOCK_N,
    tune_candidates=_TUNE_BLOCK_NS,
    make_args=_lloyd_args,
)(lloyd_step_blocked)

dispatch.register(
    "lloyd_step", "ref",
    supports=lambda metric, platform, dtype, n, m, d: metric in _METRICS,
    priority=lambda platform: 0,
    default_block_n=lambda platform: _DEFAULT_BLOCK_N,
    make_args=_lloyd_args,
)(lloyd_step_reference)

dispatch.register(
    "lloyd_step", "cuda",
    supports=lambda metric, platform, dtype, n, m, d: (
        metric in LLOYD_METRICS and dtype in DTYPE_CODES),
    priority=lambda platform: 10 if platform == "cuda" else -1,
    default_block_n=lambda platform: 0,
    make_args=_lloyd_args,
)(lloyd_step_cuda_backend)


def lloyd_step(x, w, c, *, metric: str = "l2sq",
               policy: Optional[KernelPolicy] = None):
    """Returns (sums (k,d), counts (k,), assignment (n,) int32, dist (n,)).
    Counted in ``kernels.pairs`` (``dispatch.count_pairs``) under the CUDA
    route or ``ref``; on the blocked path its assignment, a ``min_argmin``
    call, counts its pairs."""
    n, d = x.shape
    k = c.shape[0]
    platform = dispatch.platform_of(x)
    policy = dispatch.resolve_policy(policy)
    reg, bn = dispatch.resolve("lloyd_step", policy, metric=metric, n=n,
                               m=k, d=d, dtype=x.dtype, platform=platform)
    if obs.detail_on() and reg.name != "blocked":
        dispatch.count_pairs(
            "lloyd_step", lloyd_plan(n, k, d).route
            if reg.name == "cuda" and platform == "cuda" else reg.name, n, k)
    if reg.name == "blocked":
        # the assignment follows the same policy: kernel A for l1 on the
        # card, the blocked torch path on the CPU or under backend="blocked";
        # a tuned Lloyd tile is its assignment's, as in the reference
        if policy.autotune and policy.block_n is None:
            policy = dataclasses.replace(policy, block_n=bn)
        return lloyd_step_blocked(x, w, c, metric=metric, policy=policy)
    return reg.impl(x, w, c, metric=metric, block_n=bn)
