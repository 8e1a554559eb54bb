"""One front door over the pipeline: declarative config + session facade.

Port of ``repro.api``.  ``PipelineConfig`` (``config.py``) is the single
serializable description of a run — problem, summarizer policy, kernel
policy, topology — and ``Session`` (``session.py``) is the single verb set
(``fit`` / ``ingest`` / ``refresh`` / ``score`` / ``save`` / ``load``)
driving ``simulate_coordinator``, ``distributed_cluster``,
``StreamService`` or ``ShardedStreamService`` behind it, bit-identical to
calling those layers directly.  ``Session.score_stream`` adds the async
serving path (``repro_torch.serve``: continuous batching + admission
control, configured by the config's optional ``serving`` section); the
optional ``tracing`` section (``repro_torch.obs.TraceSpec``) pins the
flight recorder's sampling knobs, and ``Session.dump_trace`` exports it.
``python -m repro_torch`` (``cli.py``) executes a config file.
"""
from repro_torch.api.config import (  # noqa: F401
    PARTITIONS, PipelineConfig, ProblemSpec, SITE_BUDGETS, TOPOLOGIES,
    TopologySpec, pipeline_config, register_config_migration,
)
from repro_torch.obs.tracing import TraceSpec  # noqa: F401
from repro_torch.store import StoreSpec, TieredStore  # noqa: F401
from repro_torch.api.session import OneshotEngine, Session  # noqa: F401
from repro_torch.serve import (  # noqa: F401
    ScoreTicket, ServingScheduler, ServingSpec, ShedReject,
)
