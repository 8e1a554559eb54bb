"""Training runtime, port of ``repro.runtime``: the straggler monitor
(``straggler``), Byzantine-robust gradient aggregation (``robust_agg``)
and the elastic runner (``elastic``)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    DeviceFailure, ElasticConfig, ElasticRunner,
)
from repro_torch.runtime.robust_agg import (  # noqa: F401
    robust_mean_grads, sketch,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
