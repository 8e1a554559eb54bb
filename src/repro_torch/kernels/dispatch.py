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
policy serves both.

``KernelPolicy(autotune=True)`` turns on the reference's tile autotuner:
candidate ``block_n`` tiles (and, for ``score``, ``block_m`` jointly) are
timed per (op, backend, metric, shape bucket, platform) and the winner is
cached in a JSON file, ``$REPRO_TORCH_KERNELS_CACHE/autotune.json``
(default ``~/.cache/repro_torch_kernels/``).  The file is the port's own:
the reference keys its file by JAX's platform names, and both packages
write ``cpu`` keys for ``blocked``, so the two never share one.  Only the
``blocked`` and ``int8`` registrations carry candidates (the reference's
``blocked`` ones).  The ``cuda`` kernels' tiles are compile-time constants
per padded width (``csrc/*.cu``) and their wrappers ignore ``block_n``, so
a call that resolves to ``cuda`` gets the defaults and measures nothing,
as the reference does for a backend with no candidates; the reference's
Pallas candidates are VMEM choices and do not carry over.  A route or tile
tuner for the CUDA kernels is ROADMAP.md's R2, not this tuner.

Telemetry: ``kernels.dispatch{op=,backend=}`` counts registry decisions,
``kernels.autotune_cache{result=hit|miss}`` the tuner's cache lookups, and
a ``kernels.autotune`` span times each measurement.  The reference
resolves at trace time, so under ``jit`` its ``kernels.dispatch`` counts
one decision per compiled (op, policy, shape, dtype), not one per call.
The port resolves on every call, through a memo keyed by (op, policy,
metric, platform, dtype, n, m, d), so it counts on a memo miss: one per
distinct resolution, the counterpart of one trace.  A per-call count would
cost the serving read host time it cannot spare.  The memo is dropped when
a new default metrics registry is installed, so each registry counts the
resolutions made under it.  ``kernels.pairs{op=,route=}``
(:func:`count_pairs`) adds up the (row, center) pairs each ``min_argmin``
and ``lloyd_step`` call asks for, by the route that serves it, while a
``torch.profiler`` records (``obs.detail_on()``); otherwise it costs that
one check.

The fourth kernel, the chunked WKV6 forward (``kernels/wkv``), is not an op
of this registry, as in the reference: the RWKV6 block routes to it by
``cfg.wkv_use_pallas`` (``models/rwkv6.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs

_log = logging.getLogger("repro_torch.kernels.dispatch")

BACKENDS = ("auto", "cuda", "blocked", "ref", "int8")

OPS = ("min_argmin", "lloyd_step", "score")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """The one kernel-selection object threaded through the algorithm layers.

    backend   — "auto" (pick per platform/capability), or an explicit
                registry name.  An explicit backend that cannot serve a
                particular call falls back to auto selection for that call,
                as in the reference.
    block_n   — row-tile size of the plain ``blocked`` paths; None means
                "backend default, or autotuned when ``autotune`` is set".
    autotune  — measure candidate tiles for this op/shape bucket (cached on
                disk) instead of using the backend default.
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


class Registration(NamedTuple):
    """One backend implementation of one op (see ``repro.kernels.dispatch``).

    2-D ops (``score``) also register ``default_block_m`` (platform -> int)
    plus ``tune_candidates_m``, and their ``impl`` takes a ``block_m``
    keyword.  ``make_args`` builds the autotuner's operands as numpy arrays
    (None: an (x, c) pair of standard normals).
    """

    op: str
    name: str
    impl: Callable                 # op-specific signature, kw block_n
    supports: Callable             # (metric, platform, dtype, n, m, d) -> bool
    priority: Callable             # platform -> int; < 0 means never auto-picked
    default_block_n: Callable      # platform -> int
    tune_candidates: tuple = ()    # candidate block_n values for the autotuner
    make_args: Optional[Callable] = None   # (n, m, d, rng) -> impl's args
    default_block_m: Optional[Callable] = None   # platform -> int (2-D ops)
    tune_candidates_m: tuple = ()  # candidate block_m values (2-D ops)


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
             default_block_n: Callable, tune_candidates: Sequence[int] = (),
             make_args: Callable = None, default_block_m: Callable = None,
             tune_candidates_m: Sequence[int] = ()):
    """Decorator: register ``fn`` as the ``name`` backend of ``op``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")

    def deco(fn):
        _memo.clear()
        _REGISTRY.setdefault(op, {})[name] = Registration(
            op=op, name=name, impl=fn, supports=supports, priority=priority,
            default_block_n=default_block_n,
            tune_candidates=tuple(tune_candidates), make_args=make_args,
            default_block_m=default_block_m,
            tune_candidates_m=tuple(tune_candidates_m))
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
# function of (op, policy, metric, platform, dtype, n, m, d), the registry
# and the autotune cache alone, and resolving it anew cost 3.1-5.9 us of
# host time per serving read on the H100 machine's host (PERF.md).  Under
# ``autotune`` the memo holds the tuned tiles, so a miss measures once per
# (policy, shape) in a process and at most once per shape bucket across
# processes (the disk cache).  register() and clear_autotune_cache() clear
# it; a new default policy is a new key.  Bounded: cleared when full (a
# fit's calls vary n).
_MEMO_MAX = 4096
_memo: dict[tuple, tuple[Registration, int, int]] = {}
_memo_registry = None   # the metrics registry the memo's misses counted in


def _tiles(op, reg, policy, metric, n, m, d, platform):
    """(block_n, block_m) for one call under ``policy`` — the reference's
    ``resolve_tiles`` rule; block_m is 0 for a 1-D registration.  An
    explicit ``policy.block_n`` pins the row tile and disables the tuner."""
    tune = (policy.autotune and policy.block_n is None
            and bool(reg.tune_candidates))
    if reg.default_block_m is None:
        bn = policy.block_n
        if bn is None:
            bn = (autotune_block_n(op, reg.name, metric=metric, n=n, m=m,
                                   d=d, platform=platform)
                  if tune else reg.default_block_n(platform))
        return int(bn), 0
    bn, bm = policy.block_n, None
    if tune:
        bn, bm = autotune_tiles(op, reg.name, metric=metric, n=n, m=m, d=d,
                                platform=platform)
    if bn is None:
        bn = reg.default_block_n(platform)
    if bm is None:
        bm = reg.default_block_m(platform)
    return int(bn), int(bm)


def _resolved(op, policy, metric, n, m, d, dtype, platform):
    global _memo_registry
    policy = resolve_policy(policy)
    metrics = obs.get_default_registry()
    if metrics is not _memo_registry:
        _memo.clear()
        _memo_registry = metrics
    key = (op, policy, metric, platform, dtype, n, m, d)
    hit = _memo.get(key)
    if hit is None:
        reg = select_backend(op, policy, metric=metric, n=n, m=m, d=d,
                             dtype=dtype, platform=platform)
        hit = (reg, *_tiles(op, reg, policy, metric, n, m, d, platform))
        if _tuning:
            return hit   # a measurement's inner call: defaults, not memoized
        obs.counter("kernels.dispatch", op=op, backend=reg.name).inc()
        if len(_memo) >= _MEMO_MAX:
            _memo.clear()
        _memo[key] = hit
    return hit


def resolve(op: str, policy: Optional[KernelPolicy] = None, *, metric: str,
            n: int, m: int, d: int, dtype=torch.float32,
            platform: str = "cpu") -> tuple[Registration, int]:
    """Registry lookup: (registration, block_n) for one concrete call."""
    reg, bn, _ = _resolved(op, policy, metric, n, m, d, dtype, platform)
    return reg, bn


def count_pairs(op: str, route: str, n: int, m: int) -> None:
    """Add a call's n m (row, center) pairs to ``kernels.pairs{op=,
    route=}``: the distance work it asks for (module docstring).  The
    caller asks :func:`obs.detail_on` first."""
    obs.get_default_registry().counter("kernels.pairs", op=op,
                                       route=route).inc(n * m)


def resolve_tiles(op: str, policy: Optional[KernelPolicy] = None, *,
                  metric: str, n: int, m: int, d: int, dtype=torch.float32,
                  platform: str = "cpu") -> tuple[Registration, int, int]:
    """Registry lookup for a 2-D-tiled op: (registration, block_n, block_m).

    A backend registered without ``default_block_m`` gets block_m 0.  Under
    ``policy.autotune`` (and no explicit ``block_n``) the (block_n,
    block_m) pair is measured jointly per shape bucket and cached."""
    return _resolved(op, policy, metric, n, m, d, dtype, platform)


# ------------------------------------------------------------------ autotuner
# v2 (the reference's schema): 2-D ops cache the jointly-tuned (block_n,
# block_m) pair.  Keys of another version never match, and an entry that
# matches a key but lacks the fields its reader needs (a single-block_n
# record under a 2-D op's key) is skipped with a debug log and re-measured,
# never a KeyError.
_TUNE_VERSION = 2
# Shapes at/above this row bucket share one measurement (bounds tuner cost).
_MAX_MEASURE_ROWS = 1 << 17
_tune_cache: Optional[dict] = None
_tuning = False   # re-entrancy guard: a measured impl may itself resolve()


def cache_dir() -> Path:
    return Path(os.environ.get(
        "REPRO_TORCH_KERNELS_CACHE",
        "~/.cache/repro_torch_kernels")).expanduser()


def _cache_path() -> Path:
    return cache_dir() / "autotune.json"


def _bucket(v: int, lo: int = 1) -> int:
    b = max(lo, 1)
    while b < v:
        b <<= 1
    return b


def _load_cache() -> dict:
    global _tune_cache
    if _tune_cache is None:
        try:
            _tune_cache = json.loads(_cache_path().read_text())
        except (OSError, ValueError):
            _tune_cache = {}
        stale = [k for k in _tune_cache
                 if not k.startswith(f"v{_TUNE_VERSION}/")]
        if stale:
            _log.debug("autotune cache %s holds %d entr%s from older schema "
                       "versions (e.g. %s); they are ignored, not migrated",
                       _cache_path(), len(stale),
                       "y" if len(stale) == 1 else "ies", stale[0])
    return _tune_cache


def _cache_hit(key: str, required: Sequence[str]) -> Optional[dict]:
    """Cached entry for ``key`` iff it carries every ``required`` field."""
    hit = _load_cache().get(key)
    if not isinstance(hit, dict):
        return None
    missing = [f for f in required if f not in hit]
    if missing:
        _log.debug("stale autotune entry %s (missing %s); re-measuring",
                   key, ", ".join(missing))
        return None
    return hit


def _store_cache(key: str, entry: dict) -> None:
    cache = _load_cache()
    cache[key] = entry
    try:
        cache_dir().mkdir(parents=True, exist_ok=True)
        tmp = _cache_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
        tmp.replace(_cache_path())
    except OSError:
        pass   # cache is an optimization; never fail the caller over it


def clear_autotune_cache(*, on_disk: bool = False) -> None:
    """Drop the in-memory autotune cache and the resolution memo that holds
    tuned tiles (and optionally the JSON file)."""
    global _tune_cache
    _tune_cache = None
    _memo.clear()
    if on_disk:
        try:
            _cache_path().unlink()
        except OSError:
            pass


def _default_make_args(n: int, m: int, d: int, rng: np.random.Generator):
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((m, d)).astype(np.float32)
    return (x, c)


def _operands(reg: Registration, n: int, m: int, d: int, platform: str):
    """The measurement's operands, from ``default_rng(0)`` as in the
    reference, as tensors on the call's platform."""
    make = reg.make_args or _default_make_args
    dev = torch.device(platform)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in make(n, m, d, np.random.default_rng(0)))


def _time_call(fn, *, repeats: int, platform: str) -> float:
    """Best of ``repeats`` wall times of ``fn()``, one warm call outside the
    clock; on a ``cuda`` platform each call ends in a device synchronize
    (the reference's ``jax.block_until_ready``)."""
    dev = torch.device(platform)

    def done():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    done()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        done()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_block_ns(op: str, backend: str, *, metric: str, n: int, m: int,
                     d: int, candidates: Optional[Sequence[int]] = None,
                     repeats: int = 3,
                     platform: str = "cpu") -> dict[int, float]:
    """Time ``op``'s ``backend`` impl at each candidate block_n (seconds)."""
    reg = registered_backends(op)[backend]
    cands = list(candidates if candidates is not None else reg.tune_candidates)
    if not cands:
        cands = [reg.default_block_n(platform)]
    args = _operands(reg, n, m, d, platform)
    return {bn: _time_call(
        functools.partial(reg.impl, *args, metric=metric, block_n=bn),
        repeats=repeats, platform=platform) for bn in cands}


def measure_tiles(op: str, backend: str, *, metric: str, n: int, m: int,
                  d: int, candidates: Sequence[tuple[int, int]],
                  repeats: int = 3,
                  platform: str = "cpu") -> dict[tuple[int, int], float]:
    """Time a 2-D op's impl at each candidate (block_n, block_m) pair."""
    reg = registered_backends(op)[backend]
    args = _operands(reg, n, m, d, platform)
    return {(bn, bm): _time_call(
        functools.partial(reg.impl, *args, metric=metric,
                          block_n=bn, block_m=bm),
        repeats=repeats, platform=platform) for bn, bm in candidates}


def _tune_key(op, backend, platform, metric, n, m, d) -> str:
    return (f"v{_TUNE_VERSION}/{op}/{backend}/{platform}/{metric}/"
            f"n{n}/m{m}/d{d}")


def autotune_block_n(op: str, backend: str, *, metric: str, n: int, m: int,
                     d: int, platform: str = "cpu", repeats: int = 3) -> int:
    """Best block_n for (op, backend, metric, shape-bucket, platform).

    Cached in ``cache_dir()/autotune.json``; one measurement per bucket.
    A backend with no candidates (``cuda``) returns its default."""
    global _tuning
    reg = registered_backends(op)[backend]
    if not reg.tune_candidates or _tuning:
        return reg.default_block_n(platform)
    bn_rows = min(_bucket(n), _MAX_MEASURE_ROWS)
    bm, bd = _bucket(m), _bucket(d)
    key = _tune_key(op, backend, platform, metric, bn_rows, bm, bd)
    hit = _cache_hit(key, ("block_n",))
    if hit is not None:
        obs.counter("kernels.autotune_cache", result="hit").inc()
        return int(hit["block_n"])
    obs.counter("kernels.autotune_cache", result="miss").inc()
    _tuning = True
    try:
        with obs.trace("kernels.autotune", op=op, backend=backend):
            cands = sorted({min(c, bn_rows) for c in reg.tune_candidates})
            timings = measure_block_ns(op, backend, metric=metric, n=bn_rows,
                                       m=bm, d=bd, candidates=cands,
                                       repeats=repeats, platform=platform)
    finally:
        _tuning = False
    best = min(timings, key=timings.get)
    _store_cache(key, {
        "block_n": int(best),
        "timings_us": {str(bn): round(t * 1e6, 2)
                       for bn, t in timings.items()},
        "measured_shape": [bn_rows, bm, bd],
    })
    return int(best)


def autotune_tiles(op: str, backend: str, *, metric: str, n: int, m: int,
                   d: int, platform: str = "cpu",
                   repeats: int = 3) -> tuple[int, int]:
    """Best jointly-tuned (block_n, block_m) pair for a 2-D op.

    The candidate grid is the cross product of the backend's row-tile and
    center-tile candidates, each clipped to its shape bucket; the pair is
    measured together.  Shares the v2 keyspace with
    :func:`autotune_block_n`; an entry lacking ``block_m`` is re-measured.
    """
    global _tuning
    reg = registered_backends(op)[backend]
    if reg.default_block_m is None:
        raise ValueError(f"op {op!r} backend {backend!r} registered no "
                         f"block_m dimension; use autotune_block_n")
    if not reg.tune_candidates or _tuning:
        return (reg.default_block_n(platform), reg.default_block_m(platform))
    bn_rows = min(_bucket(n), _MAX_MEASURE_ROWS)
    bm_cols, bd = _bucket(m), _bucket(d)
    key = _tune_key(op, backend, platform, metric, bn_rows, bm_cols, bd)
    hit = _cache_hit(key, ("block_n", "block_m"))
    if hit is not None:
        obs.counter("kernels.autotune_cache", result="hit").inc()
        return int(hit["block_n"]), int(hit["block_m"])
    obs.counter("kernels.autotune_cache", result="miss").inc()
    _tuning = True
    try:
        with obs.trace("kernels.autotune", op=op, backend=backend):
            bns = sorted({min(c, bn_rows) for c in reg.tune_candidates})
            bms = sorted({min(c, bm_cols) for c in (
                reg.tune_candidates_m or (reg.default_block_m(platform),))})
            timings = measure_tiles(op, backend, metric=metric, n=bn_rows,
                                    m=bm_cols, d=bd,
                                    candidates=[(bn, bm) for bn in bns
                                                for bm in bms],
                                    repeats=repeats, platform=platform)
    finally:
        _tuning = False
    best = min(timings, key=timings.get)
    _store_cache(key, {
        "block_n": int(best[0]),
        "block_m": int(best[1]),
        "timings_us": {f"{bn}x{bm}": round(t * 1e6, 2)
                       for (bn, bm), t in timings.items()},
        "measured_shape": [bn_rows, bm_cols, bd],
    })
    return int(best[0]), int(best[1])
