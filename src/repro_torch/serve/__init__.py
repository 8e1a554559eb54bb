"""Serving knobs.  Port of ``repro.serve``'s ``ServingSpec`` and
``SHED_POLICIES`` only: the scheduler (``ServingScheduler``,
``ScoreTicket``, ``ShedReject``) and the load generator are not ported
yet (ROADMAP.md, queue 4)."""
from repro_torch.serve.spec import SHED_POLICIES, ServingSpec

__all__ = ["SHED_POLICIES", "ServingSpec"]
