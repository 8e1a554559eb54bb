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

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.lloyd.kernel import LLOYD_METRICS, lloyd_step_cuda
from repro_torch.kernels.lloyd.ref import lloyd_step_ref
from repro_torch.kernels.pdist.kernel import DTYPE_CODES
from repro_torch.kernels.pdist.ops import min_argmin

_DEFAULT_BLOCK_N = 16384
_METRICS = ("l2sq", "l2", "l1", "cosine")


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
                       block_n: int = 0):
    """Assignment through the dispatched ``min_argmin`` under ``policy``
    (kernel A on the card, the chunked torch path on the CPU or under
    ``backend="blocked"``) + one-hot matmul accumulate.  ``block_n`` is
    unused: the assignment takes its tile from ``policy``."""
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
)(lloyd_step_blocked)

dispatch.register(
    "lloyd_step", "ref",
    supports=lambda metric, platform, dtype, n, m, d: metric in _METRICS,
    priority=lambda platform: 0,
    default_block_n=lambda platform: _DEFAULT_BLOCK_N,
)(lloyd_step_reference)

dispatch.register(
    "lloyd_step", "cuda",
    supports=lambda metric, platform, dtype, n, m, d: (
        metric in LLOYD_METRICS and dtype in DTYPE_CODES),
    priority=lambda platform: 10 if platform == "cuda" else -1,
    default_block_n=lambda platform: 0,
)(lloyd_step_cuda_backend)


def lloyd_step(x, w, c, *, metric: str = "l2sq",
               policy: Optional[KernelPolicy] = None):
    """Returns (sums (k,d), counts (k,), assignment (n,) int32, dist (n,))."""
    n, d = x.shape
    policy = dispatch.resolve_policy(policy)
    reg, bn = dispatch.resolve("lloyd_step", policy, metric=metric, n=n,
                               m=c.shape[0], d=d, dtype=x.dtype,
                               platform=dispatch.platform_of(x))
    if reg.name == "blocked":
        # the assignment follows the same policy: kernel A for l1 on the
        # card, the blocked torch path on the CPU or under backend="blocked"
        return lloyd_step_blocked(x, w, c, metric=metric, policy=policy)
    return reg.impl(x, w, c, metric=metric, block_n=bn)
