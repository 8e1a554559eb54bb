"""Compute hot-spot ops (pdist / lloyd / score): each has a hand-written
CUDA kernel for Hopper, a chunked blocked torch path and a torch oracle.
Backend selection is centralized in `dispatch` — see KernelPolicy.  The
WKV6 kernel (`wkv`) is routed by the model's config instead."""
from repro_torch.kernels.dispatch import (  # noqa: F401
    KernelPolicy, get_default_policy, set_default_policy, using_policy,
)
