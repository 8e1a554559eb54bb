"""One front door over the pipeline: declarative config + session facade.

Port of ``repro.api``.  ``PipelineConfig`` (``config.py``) is the single
serializable description of a run — problem, summarizer policy, kernel
policy, topology — and ``Session`` (``session.py``) is the single verb set
(``fit`` / ``ingest`` / ``refresh`` / ``score`` / ``save`` / ``load``)
driving ``simulate_coordinator`` or ``StreamService`` behind it,
bit-identical to calling those layers directly.  ``python -m repro_torch``
(``cli.py``) executes a config file.  The async serving path
(``ScoreTicket``, ``ServingScheduler``, ``ShedReject``) and the telemetry
the ``tracing`` section configures are not ported yet (ROADMAP.md, queue
4); ``ServingSpec`` and ``TraceSpec`` are, as the config sections they
are.
"""
from repro_torch.api.config import (  # noqa: F401
    PARTITIONS, PipelineConfig, ProblemSpec, SITE_BUDGETS, TOPOLOGIES,
    TopologySpec, pipeline_config, register_config_migration,
)
from repro_torch.obs.tracing import TraceSpec  # noqa: F401
from repro_torch.store import StoreSpec, TieredStore  # noqa: F401
from repro_torch.api.session import OneshotEngine, Session  # noqa: F401
from repro_torch.serve import ServingSpec  # noqa: F401
