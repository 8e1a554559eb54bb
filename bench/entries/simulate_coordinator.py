"""Entry ``simulate_coordinator``: the s sites in one process, over
``torch.tensor_split`` views of the rows resident on the card, as the
paper's Tables 3 and 4 run Algorithm 3."""
import torch


def make_fit(cfg: dict, x: torch.Tensor, device, kwargs: dict):
    from repro_torch.core import simulate_coordinator
    from repro_torch.core.sampler import TorchSampler
    parts = torch.tensor_split(x, int(cfg["sites"]))

    def fit(seed: int) -> dict:
        res = simulate_coordinator(parts, TorchSampler(seed), **kwargs)
        keys = ("summary_ids", "summary_weights", "summary_candidates",
                "centers", "outlier_ids", "cost", "comm_records", "phase_s")
        return {k: res[k] for k in keys}
    return fit
