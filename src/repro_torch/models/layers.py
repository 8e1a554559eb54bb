"""The shared layers RWKV6 uses, port of part of ``repro.models.layers``:
RMSNorm, dense and embedding initialisers, the embedding lookup and the
f32 unembedding.

The reference threads sharding hints through ``ShardCtx``; the port has no
mesh yet, so it has no counterpart and the hints are dropped.  Attention,
RoPE and the MLP come with the slice that ports a dense family
(``ROADMAP.md``).

Initialisers draw from an explicit ``torch.Generator`` with the reference's
distributions (not its numbers: ``jax.random`` and torch draw differently;
``transformer.params_from_numpy`` carries the reference's own weights
across).  Each fills a tensor the caller allocated, so a model is built on
its device without a copy on the host.
"""
from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Holds the ``scale`` parameter (the reference's ``{"scale": ...}``)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(rmsnorm_init(d, device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """f32 inside, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense_init(w: torch.Tensor, gen: torch.Generator,
               scale: float = 1.0) -> torch.Tensor:
    """Fill ``w`` (d_in, d_out) with N(0, 1) * scale / sqrt(d_in), drawn in
    f32 and cast to w's dtype."""
    std = scale * (w.shape[0] ** -0.5)
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device).mul_(std))
    return w


def embed_init(table: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill the (vocab, d) table with N(0, 1) * 0.02."""
    with torch.no_grad():
        table.copy_(torch.randn(table.shape, generator=gen,
                                dtype=torch.float32,
                                device=table.device).mul_(0.02))
    return table


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 from lm_head w (D, V)."""
    return x.float() @ w.float()
