"""The cells' data, made on the device from the seed.

A configuration names its dataset; ``bench/datasets/<dataset>.py`` makes
the rows, so a new dataset is a new file.  Each exposes ``make(n, d, gen,
device, **dataset_args)`` and returns ``(x float32 (n, d) on device, truth
bool (n,))``, ``truth`` marking the planted outliers; it draws with
``gen``, a ``torch.Generator`` on ``device``, in a few large calls, so the
rows are drawn where they are used.  The same (config, seed, device type)
gives the same rows.
"""
from __future__ import annotations

import torch

from bench.harness.spec import load_named


def znorm(x: torch.Tensor) -> torch.Tensor:
    """Columns to zero mean and unit (population) deviation, in place, as
    the paper's preprocessing and the numpy generators do; moments in f64.
    Shared by the datasets."""
    mean = x.mean(0, dtype=torch.float64)
    var = torch.zeros_like(mean)
    for lo in range(0, x.shape[0], 1 << 20):        # bounded f64 scratch
        var += ((x[lo:lo + (1 << 20)].double() - mean) ** 2).sum(0)
    std = (var / x.shape[0]).sqrt()
    return x.sub_(mean.float()).div_((std + 1e-9).float())


def make_data(cfg: dict, seed: int, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The configuration's rows from ``seed``: ``cfg["dataset"]`` names the
    file of ``bench/datasets``, ``cfg["dataset_args"]`` its sizes,
    ``cfg["n"]`` and ``cfg["d"]`` the shape."""
    make = load_named("datasets", cfg["dataset"]).make
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return make(n=int(cfg["n"]), d=int(cfg["d"]), gen=gen, device=device,
                **cfg.get("dataset_args", {}))
