"""Dataset ``susy_like``: SUSY-Δ's stand-in, made on the device from the
seed.  A torch copy of ``repro_torch.data.synthetic.susy_like`` (and of the
reference package's generator it ports): the same distribution, drawn by a
``torch.Generator`` on ``device`` in a few large calls."""
import torch

from bench.harness.data import znorm


def make(n: int, d: int, gen: torch.Generator, device, t: int,
         delta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """SUSY-Δ's stand-in: a two-component N(mu_c, I) mixture (signal and
    background, mu_c ~ N(0, I)), z-normalised, then t distinct rows
    shifted by U[-delta, delta]^d (the planted outliers)."""
    comp = torch.randint(0, 2, (n,), generator=gen, device=device)
    mu = torch.randn((2, d), generator=gen, device=device)
    x = torch.randn((n, d), generator=gen, device=device).add_(mu[comp])
    x = znorm(x)
    out = torch.randperm(n, generator=gen, device=device)[:t]
    x[out] += (torch.rand((t, d), generator=gen, device=device) * 2.0
               - 1.0) * delta
    truth = torch.zeros((n,), dtype=torch.bool, device=device)
    truth[out] = True
    return x, truth
