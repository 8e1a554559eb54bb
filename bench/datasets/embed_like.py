"""Dataset ``embed_like``: a stand-in for LM document embeddings (unit rows,
as an encoder's pooled and normalised outputs are), made on the device from
the seed.  No real embeddings ship with the repository."""
import math

import torch

CHUNK = 1 << 18             # rows drawn at once (bounded scratch)


def make(n: int, d: int, gen: torch.Generator, device, t: int, topics: int,
         zipf: float, noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``topics`` directions uniform on the unit sphere; each row's topic
    drawn with probability proportional to rank ** -zipf (a few topics
    hold most documents, as in web corpora); each row
    ``normalize(mu_topic + noise * g / sqrt(d))``, g standard normal (at
    noise 1, cosine ~0.71 to its topic); then t distinct rows replaced by
    uniform unit vectors, the planted outliers."""
    mu = torch.nn.functional.normalize(
        torch.randn((topics, d), generator=gen, device=device), dim=1)
    rank = torch.arange(1, topics + 1, device=device, dtype=torch.float64)
    share = rank.pow(-float(zipf))
    topic = torch.multinomial((share / share.sum()).float(), n,
                              replacement=True, generator=gen)
    x = torch.empty((n, d), device=device)
    scale = float(noise) / math.sqrt(d)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        blk = torch.randn((hi - lo, d), generator=gen, device=device)
        blk.mul_(scale).add_(mu[topic[lo:hi]])
        x[lo:hi] = torch.nn.functional.normalize(blk, dim=1)
    out = torch.randperm(n, generator=gen, device=device)[:t]
    x[out] = torch.nn.functional.normalize(
        torch.randn((t, d), generator=gen, device=device), dim=1)
    truth = torch.zeros((n,), dtype=torch.bool, device=device)
    truth[out] = True
    return x, truth
