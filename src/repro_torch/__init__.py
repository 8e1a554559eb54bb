"""PyTorch + CUDA port of the distributed clustering / outlier-detection
system in ``repro`` (the JAX reference, which stays the parity target).

Layout copies ``repro`` module for module, so each reference file has one
counterpart: ``repro.core.summary`` -> ``repro_torch.core.summary`` and so
on.  The compute hot-spots (``min_argmin``, ``lloyd_step``, ``score`` on the
clustering path, the chunked WKV6 forward on the rwkv6 serving path) have
hand-written CUDA kernels for Hopper (``kernels/csrc``), built with nvcc at
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
    OneshotEngine, PARTITIONS, PipelineConfig, ProblemSpec, SITE_BUDGETS,
    Session, ServingSpec, StoreSpec, TOPOLOGIES, TieredStore, TopologySpec,
    TraceSpec, pipeline_config, register_config_migration,
)

__all__ = [
    "resolve_device",
    "PipelineConfig", "ProblemSpec", "TopologySpec", "TOPOLOGIES",
    "PARTITIONS", "SITE_BUDGETS", "pipeline_config",
    "register_config_migration", "Session", "OneshotEngine",
    "StoreSpec", "TieredStore", "TraceSpec", "ServingSpec",
]
