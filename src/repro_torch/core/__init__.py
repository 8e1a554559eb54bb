"""Algorithms of the paper (Alg. 1/2/3, k-means++, k-means--) and its
baselines (`rand`, k-means||), ported from ``repro.core``: plain torch
around the dispatched kernel ops."""
from repro_torch.core.kmeans_parallel import kmeans_parallel_summary  # noqa: F401
from repro_torch.core.rand_summary import rand_summary  # noqa: F401
