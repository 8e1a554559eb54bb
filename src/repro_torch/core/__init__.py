"""Algorithms of the paper (Alg. 1/2/3, k-means++, k-means--) and its
baselines (`rand`, k-means||), ported from ``repro.core``: plain torch
around the dispatched kernel ops; Algorithm 3's one round of communication
on ``torch.distributed`` (``collective``).  The reference's ``sites_mesh``
(a JAX device mesh) has no counterpart: a ``torch.distributed`` group
(``init_sites`` / ``sites_group``) takes its place."""
from repro_torch.core.summary import (  # noqa: F401
    Summary, summary_outliers, summary_outliers_compact, information_loss,
)
from repro_torch.core.augmented import augmented_summary_outliers  # noqa: F401
from repro_torch.core.kmeans_mm import (  # noqa: F401
    OutlierClustering, kmeans_minus_minus,
)
from repro_torch.core.kmeans_pp import (  # noqa: F401
    kmeanspp_seed, kmeanspp_summary, pp_budget,
)
from repro_torch.core.collective import (  # noqa: F401
    choose_backend, gather_sites, gathered_bytes, init_sites, payload_bytes,
    replicated_coordinator, sites_group,
)
from repro_torch.core.distributed import (  # noqa: F401
    DistClusterResult, distributed_cluster, local_budget,
    simulate_coordinator,
)
from repro_torch.core.kmeans_parallel import kmeans_parallel_summary  # noqa: F401
from repro_torch.core.rand_summary import rand_summary  # noqa: F401
from repro_torch.core.metrics import clustering_losses, outlier_scores  # noqa: F401
