"""Streaming clustering service: merge-and-reduce over Summary-Outliers.

Port of ``repro.stream`` (see its docstring for why merge-and-reduce is
correct here): ``weighted`` (weighted Algorithm 1 + merge/reduce
primitives), ``tree`` (buffer tree, sliding-window eviction, tiered store,
checkpointable state), ``service`` (micro-batched scoring front end,
double-buffered and incremental refresh, checkpoint glue), ``sharded``
(per-site trees + one gathered refresh, host-simulated or a
``torch.distributed`` collective).
"""
from repro_torch.stream.weighted import (  # noqa: F401
    WeightedSummary, merge_summaries, resummarize, weighted_summary_outliers,
)
from repro_torch.stream.tree import (  # noqa: F401
    StreamTree, TreeConfig, record_cap,
)
from repro_torch.stream.service import (  # noqa: F401
    BaseServiceConfig, ModelState, QueryResult, ServiceConfig,
    ServingFrontEnd, StreamService, fit_model,
)
from repro_torch.stream.sharded import (  # noqa: F401
    RefreshStats, ShardedServiceConfig, ShardedStreamService,
)
