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
scatter-add, so bf16 outputs agree to rounding, not bit for bit.

On a mesh (``ShardCtx``) the groups are cut from each batch shard's tokens
(the reference's per-shard group size), the routing and the scatter and
gather run on each rank's own groups (DTensor has no rule for ``bincount``,
the stable sort or the accumulating ``index_put``), and the buffer goes
over the model axis by experts before the three products, as the
reference's hints put it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NO_MESH, MLP, ShardCtx, mlp,
                                       mlp_init_, normal_)
from repro_torch.models.sharding import axis_sizes


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


def _group_tokens(cfg: ModelConfig, n_tokens: int,
                  ctx: ShardCtx = NO_MESH) -> int:
    """The largest divisor of ``n_tokens`` not above
    ``cfg.moe_group_tokens`` nor a batch shard's tokens, as in the
    reference."""
    bd = 1
    if ctx.mesh is not None:
        sizes = axis_sizes(ctx.mesh)
        for a in (ctx.batch if isinstance(ctx.batch, tuple)
                  else (ctx.batch,)):
            bd *= sizes[a]
    per_shard = max(1, n_tokens // bd)
    g = int(min(cfg.moe_group_tokens, per_shard))
    while n_tokens % g:
        g -= 1
    return g


def _dispatch(xg, probs, cfg: ModelConfig, C: int):
    """Top-k routing of groups xg (G, g, D) by ``probs`` (G, g, E) into the
    (G, E, C, D) buffer.  Returns (topi, buf, the indices and weights the
    combine reads)."""
    G, g, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xg.device
    topw, topi = torch.topk(probs, K, dim=-1)                # (G, g, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    ids_f = topi.reshape(G, g * K)
    w_f = topw.reshape(G, g * K).to(xg.dtype)
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
    buf = torch.zeros((G, E, C + 1, D), dtype=xg.dtype, device=dev)
    buf = buf.index_put((gi, se, pos_c), upd, accumulate=True)[:, :, :C]
    w_sorted = torch.gather(w_f, 1, order)
    return topi, buf, (gi, se, st, pos_c, keep, w_sorted)


def _combine(ho, idx, g: int):
    """The experts' outputs ho (G, E, C, D) back to their tokens, weighted:
    (G, g, D)."""
    gi, se, st, pos_c, keep, w_sorted = idx
    G, _, C, D = ho.shape
    out = ho[gi, se, torch.clamp(pos_c, max=C - 1)]          # (G, gK, D)
    out = out * (keep[..., None] * w_sorted[..., None])
    yg = torch.zeros((G, g, D), dtype=ho.dtype, device=ho.device)
    return yg.index_put((gi, st), out, accumulate=True)


def _experts(buf, we_g, we_i, we_o):
    hg = F.silu(torch.einsum("gecd,edf->gecf", buf, we_g))
    hi = torch.einsum("gecd,edf->gecf", buf, we_i)
    return torch.einsum("gecf,efd->gecd", hg * hi, we_o)     # (G, E, C, D)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            ctx: ShardCtx = NO_MESH):
    """x: (B, S, D) -> (y (B, S, D), {"aux_loss", "drop_frac"})."""
    from repro_torch.models.layers import is_dtensor
    if ctx.mesh is not None and is_dtensor(x):
        return _moe_ffn_sharded(p, x, cfg, ctx)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    g = _group_tokens(cfg, N)
    G = N // g
    C = max(1, math.ceil(g * K / E * cfg.capacity_factor))

    xg = x.reshape(G, g, D)
    logits = xg.float() @ p.router                           # (G, g, E) f32
    probs = torch.softmax(logits, dim=-1)
    topi, buf, idx = _dispatch(xg, probs, cfg, C)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = torch.bincount(topi.reshape(-1), minlength=E).float() / (G * g * K)
    aux_loss = E * torch.sum(me * ce)

    y = _combine(_experts(buf, p.we_g, p.we_i, p.we_o), idx,
                 g).reshape(B, S, D)
    if p.shared is not None:
        y = y + mlp(p.shared, x)

    drop_frac = 1.0 - idx[4].float().mean()
    return y, {"aux_loss": aux_loss, "drop_frac": drop_frac}


def _moe_ffn_sharded(p: MoE, x, cfg: ModelConfig, ctx: ShardCtx):
    """:func:`moe_ffn` on a mesh.  The tokens stay on their batch shard
    (replicated over the model axis); each rank routes its own groups, the
    buffer's experts go over the model axis for the products (the
    reference's hints) and are gathered back over it for the combine.  The
    counts of the aux loss and of the dropped tokens are summed over the
    batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    g = _group_tokens(cfg, N, ctx)
    C = max(1, math.ceil(g * K / E * cfg.capacity_factor))
    mesh = ctx.mesh

    x = ctx.hint(x, ctx.batch, None, None)
    probs = ctx.hint(torch.softmax(x.float() @ p.router, dim=-1), ctx.batch,
                     None, None)                             # (B, S, E) f32
    me = probs.mean(dim=(0, 1))                              # (E,)
    x_l = x.to_local(grad_placements=x.placements)
    p_l = probs.to_local(grad_placements=probs.placements)
    n_l = x_l.shape[0] * S
    if n_l % g:
        raise ValueError(f"a batch shard's {n_l} tokens are not a multiple "
                         f"of the group size {g}")
    topi, buf_l, idx = _dispatch(x_l.reshape(n_l // g, g, D),
                                 p_l.reshape(n_l // g, g, E), cfg, C)
    summed = [Partial() if isinstance(pl, Shard) else Replicate()
              for pl in x.placements]

    def total(t):
        """A per-rank count summed over the batch shards."""
        return DTensor.from_local(t, mesh, summed, run_check=False) \
            .redistribute(mesh, [Replicate()] * mesh.ndim)

    ones = torch.ones(topi.numel(), dtype=torch.float32, device=topi.device)
    # bincount's length depends on the data, which fake tensors cannot
    # know; the same integer counts, exact in f32
    counts = torch.zeros(E, dtype=torch.float32,
                         device=topi.device).index_add_(0, topi.reshape(-1),
                                                        ones)
    ce = total(counts) / (N * K)
    aux_loss = E * torch.sum(me * ce)

    buf = DTensor.from_local(buf_l, mesh, x.placements, run_check=False)
    buf = ctx.hint(buf, ctx.batch, ctx.model, None, None)
    # each rank's experts on its groups (DTensor's einsum rule fails on
    # some of these layouts); the weights whole but for their experts
    ws = [ctx.hint(w, ctx.model, None, None) for w in (p.we_g, p.we_i,
                                                      p.we_o)]
    ho = ctx.local(_experts, buf, *ws, out=buf.placements, summed=(1, 2, 3))
    ho = ctx.hint(ho, ctx.batch, None, None, None)
    y_l = _combine(ho.to_local(grad_placements=ho.placements), idx, g)
    y = DTensor.from_local(y_l.reshape(x_l.shape), mesh, x.placements,
                           run_check=False)
    if p.shared is not None:
        y = y + mlp(p.shared, x, ctx)

    drop_frac = 1.0 - total(idx[4].float().sum()) / (N * K)
    return ctx.residual(y), {"aux_loss": aux_loss, "drop_frac": drop_frac}
