"""The cells' data, made on the device from the seed.

Copies of ``repro_torch.data.synthetic.kdd_like`` / ``susy_like`` (and of
the reference package's generators they port), rewritten in torch so that
the rows are drawn where they are used: the same distributions, drawn by a
``torch.Generator`` on ``device`` in a few large calls, not numpy's numbers.
The same (config, seed, device type) gives the same rows.

Each generator returns ``(x float32 (n, d) on device, truth bool (n,))``,
``truth`` marking the planted outliers.
"""
from __future__ import annotations

import torch


def _znorm(x: torch.Tensor) -> torch.Tensor:
    """Columns to zero mean and unit (population) deviation, as the
    paper's preprocessing and the numpy generators do; moments in f64."""
    mean = x.mean(0, dtype=torch.float64)
    var = torch.zeros_like(mean)
    for lo in range(0, x.shape[0], 1 << 20):        # bounded f64 scratch
        var += ((x[lo:lo + (1 << 20)].double() - mean) ** 2).sum(0)
    std = (var / x.shape[0]).sqrt()
    return x.sub_(mean.float()).div_((std + 1e-9).float())


def kdd_like(n: int, d: int, t_frac: float, gen: torch.Generator,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """kddFull's stand-in: three dominant classes (normal, neptune, smurf
    in their kddFull proportions) hold 1 - t_frac of the rows, 20 small
    clusters the rest (the planted outliers); centers N(0, 2^2), per-class
    scale U(0.2, 1), rows shuffled, then z-normalised."""
    big = torch.tensor([0.196, 0.216, 0.568], dtype=torch.float64)
    big = big / big.sum() * (1.0 - t_frac)
    fracs = torch.cat([big, torch.full((20,), t_frac / 20,
                                       dtype=torch.float64)])
    counts = torch.clamp((fracs * n).long(), min=1)
    counts[0] += n - int(counts.sum())
    ks = fracs.numel()
    centers = torch.randn((ks, d), generator=gen, device=device) * 2.0
    scales = torch.rand((ks, 1), generator=gen, device=device) * 0.8 + 0.2
    labels = torch.repeat_interleave(
        torch.arange(ks, device=device), counts.to(device))
    labels = labels[torch.randperm(n, generator=gen, device=device)]
    x = torch.randn((n, d), generator=gen, device=device)
    x.mul_(scales[labels]).add_(centers[labels])
    return _znorm(x), labels >= 3


def susy_like(n: int, d: int, t: int, delta: float, gen: torch.Generator,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """SUSY-Δ's stand-in: a two-component N(mu_c, I) mixture (signal and
    background, mu_c ~ N(0, I)), z-normalised, then t distinct rows
    shifted by U[-delta, delta]^d (the planted outliers)."""
    comp = torch.randint(0, 2, (n,), generator=gen, device=device)
    mu = torch.randn((2, d), generator=gen, device=device)
    x = torch.randn((n, d), generator=gen, device=device).add_(mu[comp])
    x = _znorm(x)
    out = torch.randperm(n, generator=gen, device=device)[:t]
    x[out] += (torch.rand((t, d), generator=gen, device=device) * 2.0
               - 1.0) * delta
    truth = torch.zeros((n,), dtype=torch.bool, device=device)
    truth[out] = True
    return x, truth


GENERATORS = {"kdd_like": kdd_like, "susy_like": susy_like}


def make_data(cfg: dict, seed: int, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The configuration's rows from ``seed``: ``cfg["dataset"]`` names the
    generator, ``cfg["dataset_args"]`` its sizes, ``cfg["n"]`` and
    ``cfg["d"]`` the shape."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    make = GENERATORS[cfg["dataset"]]
    return make(n=int(cfg["n"]), d=int(cfg["d"]), gen=gen, device=device,
                **cfg.get("dataset_args", {}))
