"""Token-choice top-k MoE with grouped, sort-based "dropped" dispatch, port
of ``repro.models.moe``.

Tokens are split into groups (``cfg.moe_group_tokens``, at most the batch's
tokens), and dispatch happens per group, as in the reference:

  router (f32) -> top-k -> renormalise -> per-group stable argsort by
  expert id -> position in expert via an exclusive cumsum of per-expert
  counts -> capacity clip (drop) -> scatter into a (G, E, C, D) buffer ->
  3 grouped products (SwiGLU experts) -> gather back -> weighted combine
  (+ optional shared expert).

Capacity C = max(1, ceil(group_tokens * K / E * capacity_factor)); a token
whose position in its expert is >= C is dropped.  The reference scatters
those to an out-of-range slot with ``mode="drop"``; the port gives the
buffer one extra slot C and slices it off.  The combine adds each token's K
expert outputs with ``index_add_``, in another order than the reference's
scatter-add, so bf16 outputs agree to rounding, not bit for bit.  The
reference's mesh (sharded groups and experts) has no counterpart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, mlp, mlp_init_, normal_


class MoE(nn.Module):
    """One MoE layer's parameters (the reference's ``moe_init`` dict):
    ``router`` (D, E) in f32 whatever the model's dtype, the experts'
    ``we_g`` / ``we_i`` (E, D, Fe) and ``we_o`` (E, Fe, D), and a
    ``shared`` expert when ``cfg.shared_expert_d_ff``.  Allocated
    uninitialised; :func:`moe_init_` draws them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        E, D, Fe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

        def par(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = par(D, E, dt=torch.float32)
        self.we_g, self.we_i, self.we_o = par(E, D, Fe), par(E, D, Fe), \
            par(E, Fe, D)
        self.shared = (MLP(D, cfg.shared_expert_d_ff, dtype, device=device)
                       if cfg.shared_expert_d_ff else None)


def moe_init_(p: MoE, gen: torch.Generator) -> MoE:
    """N(0, 1) / sqrt(D) for the router and the experts' input sides,
    N(0, 1) / sqrt(Fe) for ``we_o``."""
    D, Fe = p.we_g.shape[1], p.we_g.shape[2]
    normal_(p.router, gen, D ** -0.5)
    normal_(p.we_g, gen, D ** -0.5)
    normal_(p.we_i, gen, D ** -0.5)
    normal_(p.we_o, gen, Fe ** -0.5)
    if p.shared is not None:
        mlp_init_(p.shared, gen)
    return p


def _group_tokens(cfg: ModelConfig, n_tokens: int) -> int:
    """The largest divisor of ``n_tokens`` not above
    ``cfg.moe_group_tokens`` (one device: the reference's ``mesh=None``)."""
    g = int(min(cfg.moe_group_tokens, max(1, n_tokens)))
    while n_tokens % g:
        g -= 1
    return g


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), {"aux_loss", "drop_frac"})."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    g = _group_tokens(cfg, N)
    G = N // g
    C = max(1, math.ceil(g * K / E * cfg.capacity_factor))
    dev = x.device

    xg = x.reshape(G, g, D)
    logits = xg.float() @ p.router                           # (G, g, E) f32
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)                # (G, g, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = torch.bincount(topi.reshape(-1), minlength=E).float() / (G * g * K)
    aux_loss = E * torch.sum(me * ce)

    ids_f = topi.reshape(G, g * K)
    w_f = topw.reshape(G, g * K).to(x.dtype)
    tok_f = torch.arange(g, device=dev).repeat_interleave(K).expand(G, -1)

    order = torch.argsort(ids_f, dim=1, stable=True)
    se = torch.gather(ids_f, 1, order)                       # sorted experts
    st = torch.gather(tok_f, 1, order)                       # their tokens

    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, ids_f, torch.ones_like(ids_f))
    starts = torch.cumsum(counts, dim=1) - counts            # exclusive
    pos = torch.arange(g * K, device=dev)[None] - torch.gather(starts, 1, se)
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                        # C: dropped slot

    gi = torch.arange(G, device=dev)[:, None].expand(-1, g * K)
    upd = xg[gi, st]                                         # (G, gK, D)
    buf = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=dev)
    buf = buf.index_put((gi, se, pos_c), upd, accumulate=True)[:, :, :C]

    hg = F.silu(torch.einsum("gecd,edf->gecf", buf, p.we_g))
    hi = torch.einsum("gecd,edf->gecf", buf, p.we_i)
    ho = torch.einsum("gecf,efd->gecd", hg * hi, p.we_o)     # (G, E, C, D)

    w_sorted = torch.gather(w_f, 1, order)
    out = ho[gi, se, torch.clamp(pos_c, max=C - 1)]          # (G, gK, D)
    out = out * (keep[..., None] * w_sorted[..., None])
    yg = torch.zeros((G, g, D), dtype=x.dtype, device=dev)
    yg = yg.index_put((gi, st), out, accumulate=True)
    y = yg.reshape(B, S, D)

    if p.shared is not None:
        y = y + mlp(p.shared, x)

    drop_frac = 1.0 - keep.float().mean()
    return y, {"aux_loss": aux_loss, "drop_frac": drop_frac}
