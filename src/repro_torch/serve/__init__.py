"""Async serving: continuous batching + admission control over one model.

Port of ``repro.serve`` with the reference's exports.

The paper's summary is tiny and scoring against it is one fused score
kernel (``repro_torch.kernels.score``: pdist + argmin + threshold divide in a
single dispatch) — cheap enough that a single shared model should serve
many concurrent clients.  This package is the scheduler/worker split
that makes that true in-process:

    client threads --submit--> bounded queue --tick--> one fused score
         |                       |  admission control       per micro-batch
    score_stream()               |   queue_bound: shed|wait      |
     (Session)                   |   per-tenant quotas           v
         <------- tickets resolve with QueryResult | ShedReject --

* :class:`ServingSpec` (``spec``) — the declarative knobs (queue bound,
  batch window, shed-or-wait policy, tenant quota), carried by
  ``PipelineConfig.serving``;
* :class:`ServingScheduler` (``scheduler``) — the bounded request queue,
  admission control and the continuous-batching worker tick over any
  ``ServingFrontEnd``; per-request :class:`ScoreTicket`, typed
  :class:`ShedReject`;
* ``loadgen`` — the open-loop N-client load generator behind the
  goodput-vs-offered-load benchmark ladder and ``serve --clients N``.

Scores through the concurrent path are bit-identical to sequential
``submit``+``drain``; queue depth, shed rate, batch occupancy and
per-tenant latency land in ``repro_torch.obs``.
"""
from repro_torch.serve.spec import SHED_POLICIES, ServingSpec  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    ScoreTicket, ServingScheduler, ShedReject,
)
from repro_torch.serve.loadgen import estimate_capacity, run_load  # noqa: F401
