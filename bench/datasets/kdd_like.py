"""Dataset ``kdd_like``: kddFull's stand-in, made on the device from the
seed.  A torch copy of ``repro_torch.data.synthetic.kdd_like`` (and of the
reference package's generator it ports): the same distribution, drawn by a
``torch.Generator`` on ``device`` in a few large calls."""
import torch

from bench.harness.data import znorm


def make(n: int, d: int, gen: torch.Generator, device,
         t_frac: float) -> tuple[torch.Tensor, torch.Tensor]:
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
    return znorm(x), labels >= 3
