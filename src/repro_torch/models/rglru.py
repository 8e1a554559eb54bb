"""RecurrentGemma / Griffin blocks (arXiv:2402.19427), port of
``repro.models.rglru``: the RG-LRU recurrence that the rglru_hybrid family
interleaves 2 : 1 with local sliding-window attention.

The RG-LRU is a diagonal gated linear recurrence:

    r_t = sigmoid(x_t * w_r + b_r)
    i_t = sigmoid(x_t * w_i + b_i)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

A width-4 depthwise causal conv precedes it (carried as 3 tokens of state
at decode time).  The reference evaluates the recurrence over a prompt
with ``jax.lax.associative_scan``; the port runs a Hillis-Steele doubling
scan (:func:`linear_scan`): ceil(log2 T) passes of elementwise products
over the whole (B, T, W) block, the same work class, instead of a loop of
T small steps.  One token (decode) is the single step ``a * h + b``.
Plain torch: the reference computes all of it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NO_MESH, RMSNorm, ShardCtx,
                                       dense_init, normal_)

_C = 8.0  # Griffin's fixed scale inside a_t


class RGLRU(nn.Module):
    """One recurrent block's parameters, under the reference's names:
    ``ln.scale``, ``w_x`` / ``w_y`` (D, W), ``w_out`` (W, D), ``conv`` (4,
    W) in the model's dtype; the gates ``gate_{r,i}_{w,b}`` and ``lam``
    (W,) in f32.  Allocated uninitialised: :func:`rglru_layer_init_`
    draws them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        D = cfg.d_model
        W = cfg.lru_width or D

        def par(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.ln = RMSNorm(D, device)
        self.w_x, self.w_y, self.w_out = par(D, W), par(D, W), par(W, D)
        self.conv = par(4, W)
        f32 = torch.float32
        self.gate_r_w, self.gate_r_b = par(W, dt=f32), par(W, dt=f32)
        self.gate_i_w, self.gate_i_b = par(W, dt=f32), par(W, dt=f32)
        self.lam = par(W, dt=f32)


def rglru_layer_init_(p: RGLRU, gen: torch.Generator) -> RGLRU:
    """The reference's draw order and distributions: w_x, w_y, w_out
    N(0, 1/fan_in), conv N(0, 0.1^2), the gates zero, Lambda
    linspace(0.3, 1.5) (a ~ U[0.9, 0.999]^c at r = 1)."""
    for w in (p.w_x, p.w_y, p.w_out):
        dense_init(w, gen)
    normal_(p.conv, gen, 0.1)
    with torch.no_grad():
        for g in (p.gate_r_w, p.gate_r_b, p.gate_i_w, p.gate_i_b):
            g.zero_()
        p.lam.copy_(torch.linspace(0.3, 1.5, p.lam.shape[0],
                                   dtype=torch.float32, device=p.lam.device))
    return p


def _conv4(x: torch.Tensor, w: torch.Tensor, carry: torch.Tensor):
    """Depthwise causal conv, width 4. x: (B, T, W); carry: (B, 3, W).  The
    four products are summed in the reference's order (j = 0..3) in x's
    dtype.  Returns (out (B, T, W), the new carry: the last 3 inputs)."""
    xp = torch.cat([carry, x], dim=1)
    n = xp.shape[1]
    out = xp[:, 3:n, :] * w[3]
    for j in range(1, 4):
        out = out + xp[:, 3 - j:n - j, :] * w[3 - j]
    return out, xp[:, -3:, :]


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = a_t h_{t-1} + b_t from h_{-1} = h0, along dim 1.

    a, b: (B, T, W); h0: (B, W).  The carried state is folded into the
    first element (b_0 + a_0 h0), then a Hillis-Steele doubling: at
    distance d, element t combines with element t - d as the reference's
    ``combine((al, bl), (ar, br)) = (al * ar, bl * ar + br)``.  The
    products come in another order than XLA's tree, so the result agrees
    with the reference's to rounding, not bit for bit."""
    T = a.shape[1]
    bb = torch.cat([(b[:, :1] + a[:, :1] * h0[:, None]), b[:, 1:]], dim=1)
    aa = a
    d = 1
    while d < T:
        bb = torch.cat([bb[:, :d], bb[:, :-d] * aa[:, d:] + bb[:, d:]],
                       dim=1)
        if 2 * d < T:           # the last pass needs no products of a
            aa = torch.cat([aa[:, :d], aa[:, :-d] * aa[:, d:]], dim=1)
        d *= 2
    return bb


def _recurrence(u, w_conv, carry, h0, gr_w, gr_b, gi_w, gi_b, lam):
    """The conv, the gates and the RG-LRU over u (B, T, W) from the state
    (carry, h0).  Returns (every h_t (B, T, W) f32, the last h, the conv's
    new carry)."""
    u, conv_carry = _conv4(u, w_conv, carry)
    uf = u.float()
    r = torch.sigmoid(uf * gr_w + gr_b)
    i = torch.sigmoid(uf * gi_w + gi_b)
    # jax.nn.softplus is logaddexp(x, 0); torch.logaddexp is the same form
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-_C * softplus * r)                       # (B, T, W)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    if u.shape[1] == 1:
        h = a[:, 0] * h0 + b[:, 0]
        hs = h[:, None, :]
    else:
        hs = linear_scan(a, b, h0)
        h = hs[:, -1, :]
    return hs, h, conv_carry


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None = None, ctx: ShardCtx = NO_MESH):
    """x: (B, T, D).  ``state`` = {"h": (B, W) f32, "conv": (B, 3, W) in
    x's dtype} carried from earlier tokens; None starts from zeros.
    Returns (x + the block's output, the new state).

    On a mesh the width goes over the model axis (the reference's hints)
    and each rank runs the conv, the gates and the scan over its own rows
    and width (all of it per (row, channel), the concatenations along
    time), the block's weights read alike by every batch shard."""
    B, T, D = x.shape
    W = cfg.lru_width or D
    if state is None:
        state = {"h": torch.zeros((B, W), dtype=torch.float32,
                                  device=x.device),
                 "conv": torch.zeros((B, 3, W), dtype=x.dtype,
                                     device=x.device)}
    xn = ctx.gathered(p.ln(x, cfg.norm_eps))
    gate = F.gelu(xn @ p.w_y, approximate="tanh")   # jax.nn.gelu's default
    u = xn @ p.w_x
    weights = (p.gate_r_w, p.gate_r_b, p.gate_i_w, p.gate_i_b, p.lam)
    if ctx.mesh is not None:
        gate = ctx.hint(gate, ctx.batch, None, ctx.model)
        u = ctx.hint(u, ctx.batch, None, ctx.model)
        carry = ctx.hint(ctx.replicated(state["conv"]), ctx.batch, None,
                         ctx.model)
        h0 = ctx.hint(ctx.replicated(state["h"]), ctx.batch, ctx.model)
        hs, h, conv_carry = ctx.local(
            _recurrence, u, ctx.hint(p.conv, None, ctx.model), carry, h0,
            *(ctx.hint(w, ctx.model) for w in weights),
            out=(u.placements, h0.placements, carry.placements),
            summed=(1, 4, 5, 6, 7, 8))
    else:
        hs, h, conv_carry = _recurrence(u, p.conv, state["conv"],
                                        state["h"], *weights)
    out = (hs.to(x.dtype) * gate) @ p.w_out
    return x + ctx.residual(out), {"h": h, "conv": conv_carry}
