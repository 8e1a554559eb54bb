"""Admission-control and continuous-batching knobs: ``ServingSpec``.

Port of ``repro.serve.spec``, whole: one frozen, JSON-scalar dataclass
describing how a serving scheduler admits and batches concurrent score
requests.  ``PipelineConfig`` carries an optional ``serving`` section of
exactly this shape, so an artifact valid in one package is valid in the
other.  ``repro_torch.serve.scheduler`` reads it.

The knobs, and why each exists:

* ``queue_bound`` — the scheduler's request queue is *bounded*; an
  unbounded queue under overload turns a latency problem into an OOM plus
  unbounded p99.  When the queue is full the ``shed_policy`` decides.
* ``shed_policy`` — ``"shed"`` resolves the request immediately with a
  typed rejection (goodput stays flat and p99 stays bounded under
  overload: load-shedding); ``"wait"`` blocks the submitting client until
  space frees (backpressure propagates to the caller: no request is lost,
  offered load self-limits).
* ``batch_window_ms`` — how long a scheduler tick lingers to let more
  requests join the batch.  Larger windows raise batch occupancy (fewer,
  fuller fused score calls) at the cost of added latency at low load.
* ``tenant_quota`` — per-tenant cap on *queued* requests; one noisy
  tenant can fill at most its quota of the shared queue, so other tenants
  keep getting admitted (fairness under multi-tenant overload).
* ``max_batch`` — per-tick batch cap; ``None`` uses the engine's
  ``micro_batch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SHED_POLICIES = ("shed", "wait")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """How the scheduler admits and batches concurrent score requests."""

    queue_bound: int = 1024          # max queued (admitted, unscored) requests
    batch_window_ms: float = 2.0     # per-tick linger to fill the batch
    shed_policy: str = "shed"        # on a full queue: "shed" | "wait"
    tenant_quota: Optional[int] = None   # max queued requests per tenant
    max_batch: Optional[int] = None      # per-tick cap; None = micro_batch

    def __post_init__(self):
        _require(isinstance(self.queue_bound, int)
                 and not isinstance(self.queue_bound, bool)
                 and self.queue_bound >= 1,
                 f"serving.queue_bound must be an int >= 1, "
                 f"got {self.queue_bound!r}")
        _require(isinstance(self.batch_window_ms, (int, float))
                 and not isinstance(self.batch_window_ms, bool)
                 and self.batch_window_ms >= 0,
                 f"serving.batch_window_ms must be a number >= 0, "
                 f"got {self.batch_window_ms!r}")
        # serialization round-trips through JSON: keep the field a float
        object.__setattr__(self, "batch_window_ms",
                           float(self.batch_window_ms))
        _require(self.shed_policy in SHED_POLICIES,
                 f"serving.shed_policy must be one of {SHED_POLICIES}, "
                 f"got {self.shed_policy!r}")
        for name in ("tenant_quota", "max_batch"):
            v = getattr(self, name)
            _require(v is None or (isinstance(v, int)
                                   and not isinstance(v, bool) and v >= 1),
                     f"serving.{name} must be None or an int >= 1, "
                     f"got {v!r}")
        if self.tenant_quota is not None:
            _require(self.tenant_quota <= self.queue_bound,
                     f"serving.tenant_quota ({self.tenant_quota}) cannot "
                     f"exceed serving.queue_bound ({self.queue_bound})")
