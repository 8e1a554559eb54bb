"""Kernel-dispatch layer: backend registry + per-call backend selection.

Port of ``repro.kernels.dispatch``.  Every compute hot-spot funnels
through three ops — ``min_argmin`` (fused nearest-center distance),
``lloyd_step`` (fused Lloyd step) and ``score`` (fused serving read).
Each op has several implementations registered under a name with a
capability predicate over (metric, platform, dtype, n, m, d) and a
platform-dependent auto-selection priority:

* ``cuda``    — the hand-written Hopper kernel (``kernels/csrc``); auto-
  picked on a ``cuda`` tensor, never on the CPU,
* ``blocked`` — chunked plain-torch path (bounded memory),
* ``ref``     — the plain-torch oracle (full (n, m) matrix),
* ``int8``    — quantized-center score (changes results: opt-in only).

The platform is the tensor's device type (``"cuda"`` / ``"cpu"``), so one
policy serves both.  The reference's block-size autotuner is not ported
yet: ``KernelPolicy(autotune=True)`` raises ``NotImplementedError``.

The fourth kernel, the chunked WKV6 forward (``kernels/wkv``), is not an op
of this registry, as in the reference: the RWKV6 block routes to it by
``cfg.wkv_use_pallas`` (``models/rwkv6.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

BACKENDS = ("auto", "cuda", "blocked", "ref", "int8")

OPS = ("min_argmin", "lloyd_step", "score")

_AUTOTUNE_TODO = ("the block-size autotuner is not ported yet "
                  "(ROADMAP.md, queue 1: 'kernel autotuner')")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """The one kernel-selection object threaded through the algorithm layers.

    backend   — "auto" (pick per platform/capability), or an explicit
                registry name.  An explicit backend that cannot serve a
                particular call falls back to auto selection for that call,
                as in the reference.
    block_n   — row-tile size of the plain ``blocked`` paths; None means the
                backend default.
    autotune  — reserved for the reference's tile autotuner; not ported.
    """

    backend: str = "auto"
    block_n: Optional[int] = None
    autotune: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        bn = self.block_n
        if bn is not None and (not isinstance(bn, int)
                               or isinstance(bn, bool) or bn < 1):
            raise ValueError(
                f"block_n must be None or an int >= 1, got {bn!r}")
        if self.autotune:
            raise NotImplementedError(_AUTOTUNE_TODO)


class Registration(NamedTuple):
    """One backend implementation of one op (see ``repro.kernels.dispatch``).

    2-D ops (``score``) also register ``default_block_m`` (platform -> int)
    and their ``impl`` takes a ``block_m`` keyword.
    """

    op: str
    name: str
    impl: Callable                 # op-specific signature, kw block_n
    supports: Callable             # (metric, platform, dtype, n, m, d) -> bool
    priority: Callable             # platform -> int; < 0 means never auto-picked
    default_block_n: Callable      # platform -> int
    default_block_m: Optional[Callable] = None   # platform -> int (2-D ops)


_REGISTRY: dict[str, dict[str, Registration]] = {}
_default_policy = KernelPolicy()
_registered = False


def _ensure_registered() -> None:
    """Import the op modules so their backends land in the registry."""
    global _registered
    if _registered:
        return
    _registered = True
    from repro_torch.kernels.lloyd import ops as _lloyd_ops   # noqa: F401
    from repro_torch.kernels.pdist import ops as _pdist_ops   # noqa: F401
    from repro_torch.kernels.score import ops as _score_ops   # noqa: F401


def register(op: str, name: str, *, supports: Callable, priority: Callable,
             default_block_n: Callable, default_block_m: Callable = None):
    """Decorator: register ``fn`` as the ``name`` backend of ``op``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")

    def deco(fn):
        _memo.clear()
        _REGISTRY.setdefault(op, {})[name] = Registration(
            op=op, name=name, impl=fn, supports=supports, priority=priority,
            default_block_n=default_block_n, default_block_m=default_block_m)
        return fn

    return deco


def registered_backends(op: str) -> dict[str, Registration]:
    _ensure_registered()
    if op not in _REGISTRY:
        raise ValueError(f"no backends registered for op {op!r}")
    return _REGISTRY[op]


# --------------------------------------------------------------- policy state
def get_default_policy() -> KernelPolicy:
    return _default_policy


def set_default_policy(policy: KernelPolicy) -> KernelPolicy:
    """Install ``policy`` process-wide; returns the previous default."""
    global _default_policy
    prev = _default_policy
    _default_policy = policy
    return prev


@contextlib.contextmanager
def using_policy(policy: KernelPolicy):
    """Context manager: scoped :func:`set_default_policy`."""
    prev = set_default_policy(policy)
    try:
        yield policy
    finally:
        set_default_policy(prev)


def resolve_policy(policy: Optional[KernelPolicy] = None) -> KernelPolicy:
    """``policy``, or the process default when None."""
    return policy if policy is not None else get_default_policy()


def platform_of(x: torch.Tensor) -> str:
    """The dispatch platform of a tensor: its device type."""
    return x.device.type


# ----------------------------------------------------------------- resolution
def select_backend(op: str, policy: Optional[KernelPolicy] = None, *,
                   metric: str, n: int, m: int, d: int,
                   dtype=torch.float32, platform: str = "cpu") -> Registration:
    """Pick the registration serving this call under ``policy``."""
    policy = resolve_policy(policy)
    regs = registered_backends(op)
    if policy.backend != "auto":
        reg = regs.get(policy.backend)
        if reg is None:
            raise ValueError(
                f"op {op!r} has no backend {policy.backend!r}; "
                f"registered: {sorted(regs)}")
        if reg.supports(metric, platform, dtype, n, m, d):
            return reg
        # explicit-but-unsupported falls back to auto selection for this call
    candidates = [
        r for r in regs.values()
        if r.priority(platform) >= 0
        and r.supports(metric, platform, dtype, n, m, d)
    ]
    if not candidates:
        raise ValueError(
            f"no backend of op {op!r} supports metric={metric!r} on "
            f"platform {platform!r} for shape (n={n}, m={m}, d={d})")
    return max(candidates, key=lambda r: r.priority(platform))


# Memo of resolutions.  A call's (registration, block_n, block_m) is a
# function of (op, policy, metric, platform, dtype, n, m, d) and the
# registry alone, and resolving it anew cost 3.1-5.9 us of host time per
# serving read on the H100 machine's host (PERF.md).  register() clears
# the memo; a new default policy is a new key.  Bounded: cleared when full
# (a fit's calls vary n).
_MEMO_MAX = 4096
_memo: dict[tuple, tuple[Registration, int, int]] = {}


def _resolved(op, policy, metric, n, m, d, dtype, platform):
    policy = resolve_policy(policy)
    key = (op, policy, metric, platform, dtype, n, m, d)
    hit = _memo.get(key)
    if hit is None:
        reg = select_backend(op, policy, metric=metric, n=n, m=m, d=d,
                             dtype=dtype, platform=platform)
        bn = policy.block_n if policy.block_n is not None \
            else reg.default_block_n(platform)
        bm = 0 if reg.default_block_m is None \
            else reg.default_block_m(platform)
        if len(_memo) >= _MEMO_MAX:
            _memo.clear()
        hit = _memo[key] = (reg, int(bn), int(bm))
    return hit


def resolve(op: str, policy: Optional[KernelPolicy] = None, *, metric: str,
            n: int, m: int, d: int, dtype=torch.float32,
            platform: str = "cpu") -> tuple[Registration, int]:
    """Registry lookup: (registration, block_n) for one concrete call."""
    reg, bn, _ = _resolved(op, policy, metric, n, m, d, dtype, platform)
    return reg, bn


def resolve_tiles(op: str, policy: Optional[KernelPolicy] = None, *,
                  metric: str, n: int, m: int, d: int, dtype=torch.float32,
                  platform: str = "cpu") -> tuple[Registration, int, int]:
    """Registry lookup for a 2-D-tiled op: (registration, block_n, block_m).

    A backend registered without ``default_block_m`` gets block_m 0."""
    return _resolved(op, policy, metric, n, m, d, dtype, platform)
