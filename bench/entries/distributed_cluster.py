"""Entry ``distributed_cluster``: one site a rank of the initialized
process group, each rank on its own block of ``(s, n / s, d)``.  Its
fit launches what ``simulate_coordinator``'s does."""
import torch

from bench.harness.program import algorithm3_kwargs
from bench.harness.spec import load_named

_ONE_PROCESS = load_named("entries", "simulate_coordinator")
LIBRARIES = _ONE_PROCESS.LIBRARIES
warm = _ONE_PROCESS.warm


def make_fit(cfg: dict, x: torch.Tensor, device):
    from repro_torch.core import distributed_cluster
    from repro_torch.core.sampler import TorchSampler
    n, d = x.shape
    s = int(cfg["sites"])
    parts = x.view(s, n // s, d)
    kwargs = algorithm3_kwargs(cfg, device)

    def fit(seed: int) -> dict:
        res = distributed_cluster(parts, TorchSampler(seed), **kwargs)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        # left on the card until the window closes (program.to_host)
        return {"summary_ids": res.summary_ids,
                "summary_weights": res.summary_weights,
                "summary_candidates": None,
                "centers": res.centers,
                "outlier_ids": res.outlier_ids,
                "cost": res.cost,
                "comm_records": res.comm_records,
                "phase_s": res.phase_s}
    return fit
