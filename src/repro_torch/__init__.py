"""PyTorch + CUDA port of the distributed clustering / outlier-detection
system in ``repro`` (the JAX reference, which stays the parity target).

Layout copies ``repro`` module for module, so each reference file has one
counterpart: ``repro.core.summary`` -> ``repro_torch.core.summary`` and so
on.  The compute hot-spots (``min_argmin``, ``lloyd_step``, ``score`` on the
clustering path, the chunked WKV6 forward on the rwkv6 serving and training
paths) have hand-written CUDA kernels for Hopper (``kernels/csrc``), built with nvcc at
first use; every other piece is plain torch code.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
GPU is present instead of silently running on the CPU.  The front door is
the reference's: a ``PipelineConfig`` (``pipeline_config(...)``) driven by
``Session(config, device=...)``, or ``python -m repro_torch run|serve|
bench-score --config FILE [--device cpu|cuda]``.
"""
import torch

# Full float32 everywhere on the default path: the reference computes its
# distances and Lloyd sums in f32, and TF32 keeps only ~3 decimal digits,
# which would flip argmins and break parity.  Set explicitly rather than
# trusting the defaults (cuDNN's TF32 default is on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    A CUDA device with no GPU present raises: the port never drops to the
    CPU on its own (tests ask for ``device="cpu"`` explicitly).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain torch path")
    return dev


# after resolve_device: the modules below import it from here
from repro_torch.api import (  # noqa: E402
    PipelineConfig, ProblemSpec, Session, TOPOLOGIES, TopologySpec,
    pipeline_config, register_config_migration,
)
from repro_torch.store import StoreSpec, TieredStore  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    KernelPolicy, get_default_policy, set_default_policy, using_policy,
)
from repro_torch.summarize import (  # noqa: E402
    SummarizerPolicy, get_default_summarizer, registered_summarizers,
    set_default_summarizer, summarizer_policy, using_summarizer,
)
from repro_torch.core import (  # noqa: E402
    DistClusterResult, augmented_summary_outliers, distributed_cluster,
    kmeans_minus_minus, simulate_coordinator, summary_outliers,
)
from repro_torch.stream import (  # noqa: E402
    BaseServiceConfig, ModelState, QueryResult, ServiceConfig,
    ShardedServiceConfig, ShardedStreamService, StreamService, StreamTree,
    TreeConfig, WeightedSummary, weighted_summary_outliers,
)
from repro_torch.serve import (  # noqa: E402
    ScoreTicket, ServingScheduler, ServingSpec, ShedReject,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    Alert, FlightRecorder, MetricsRegistry, TraceSpec, apply_trace_spec,
    configure_tracing, dump_trace, render_prometheus, set_metrics_enabled,
    set_tracing_enabled, using_registry,
)

# the reference's public surface (``repro.__all__``), name for name
__all__ = [
    # config + session
    "PipelineConfig", "ProblemSpec", "TopologySpec", "TOPOLOGIES",
    "pipeline_config", "Session", "register_config_migration",
    # tiered summary store
    "StoreSpec", "TieredStore",
    # policies
    "KernelPolicy", "get_default_policy", "set_default_policy",
    "using_policy",
    "SummarizerPolicy", "get_default_summarizer", "set_default_summarizer",
    "summarizer_policy", "using_summarizer", "registered_summarizers",
    # summaries + algorithms
    "summary_outliers", "augmented_summary_outliers",
    "weighted_summary_outliers", "WeightedSummary", "StreamTree",
    "TreeConfig", "kmeans_minus_minus", "distributed_cluster",
    "simulate_coordinator", "DistClusterResult",
    # serving + persistence
    "BaseServiceConfig", "ServiceConfig", "ShardedServiceConfig",
    "StreamService", "ShardedStreamService", "ModelState", "QueryResult",
    "ServingSpec", "ServingScheduler", "ScoreTicket", "ShedReject",
    "CheckpointManager",
    # observability
    "MetricsRegistry", "render_prometheus", "set_metrics_enabled",
    "using_registry",
    "Alert", "FlightRecorder", "TraceSpec", "apply_trace_spec",
    "configure_tracing", "dump_trace", "set_tracing_enabled",
]
