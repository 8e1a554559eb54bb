"""Entry ``distributed_cluster``: one site a rank of the initialized
process group, each rank on its own block of ``(s, n / s, d)``."""
import torch


def make_fit(cfg: dict, x: torch.Tensor, device, kwargs: dict):
    from repro_torch.core import distributed_cluster
    from repro_torch.core.sampler import TorchSampler
    n, d = x.shape
    s = int(cfg["sites"])
    parts = x.view(s, n // s, d)

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
