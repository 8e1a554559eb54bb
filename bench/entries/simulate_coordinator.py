"""Entry ``simulate_coordinator``: the s sites in one process, over
``torch.tensor_split`` views of the rows resident on the card, as the
paper's Tables 3 and 4 run Algorithm 3."""
import torch

from bench.harness.program import algorithm3_kwargs

LIBRARIES = ("pdist", "lloyd")      # kernels/csrc sources a fit launches


def warm(device, d: int) -> None:
    """One call of each op a fit launches, on a row of width ``d``."""
    from repro_torch.kernels.lloyd.ops import lloyd_step
    from repro_torch.kernels.pdist.ops import min_argmin
    x = torch.zeros((1, d), device=device)
    min_argmin(x, x)
    lloyd_step(x, torch.ones((1,), device=device), x)


def make_fit(cfg: dict, x: torch.Tensor, device):
    from repro_torch.core import simulate_coordinator
    from repro_torch.core.sampler import TorchSampler
    parts = torch.tensor_split(x, int(cfg["sites"]))
    kwargs = algorithm3_kwargs(cfg, device)

    def fit(seed: int) -> dict:
        res = simulate_coordinator(parts, TorchSampler(seed), **kwargs)
        keys = ("summary_ids", "summary_weights", "summary_candidates",
                "centers", "outlier_ids", "cost", "comm_records", "phase_s")
        return {k: res[k] for k in keys}
    return fit
