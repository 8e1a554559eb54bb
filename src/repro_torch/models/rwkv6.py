"""RWKV6 "Finch" (arXiv:2404.05892), port of ``repro.models.rwkv6``:
attention-free time mix with data-dependent per-channel decay, and a
squared-ReLU channel mix.

The WKV6 recurrence is evaluated chunkwise, as in the reference, per chunk
of c tokens (c = cfg.wkv_chunk):

    Lin  = cumsum(log w)                       (B,H,c,K)   f32, log-space
    A[t,tau] = exp(Lprev[t] - Lin[tau])        decay tau+1..t-1, tau < t
    o_intra  = ((r*A*k) summed over K) @ v
    o_inter  = (r * exp(Lprev)) @ S            carried state (B,H,K,V)
    S'       = exp(Lin[-1]) * S + (k * exp(Lin[-1]-Lin)) @ v

The block routes the recurrence three ways, as the reference does: the
step-by-step ``wkv_recurrent`` for one token (decode), the hand-written
chunk kernel (``kernels/wkv``, through ``wkv_forward``) when
``cfg.wkv_use_pallas`` is set, and the plain chunked ``wkv_chunked``
otherwise.  The reference's flag keeps its name: on the card it selects the
CUDA kernel.

As in the reference, the token shift uses a static learned lerp (mu), and
the decay LoRA is implemented.  Weights are drawn from an explicit
``torch.Generator`` with the reference's distributions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.wkv.kernel import wkv_forward_plain
from repro_torch.kernels.wkv.ops import wkv_forward
from repro_torch.kernels.wkv.ref import wkv_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NO_MESH, RMSNorm, ShardCtx,
                                       dense_init, is_dtensor)

LORA_RANK = 64


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype``-style name ("bfloat16", "float32") -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _register(module: nn.Module, **tensors) -> None:
    for name, t in tensors.items():
        module.register_parameter(name, nn.Parameter(t))


class RWKV6Block(nn.Module):
    """One RWKV6 layer's parameters, under the reference's names
    (``ln1.scale``, ``tmix.wr``, ``tmix.ln_out.scale``, ``cmix.wk``, ...).
    Allocated uninitialised: :func:`rwkv_layer_init` draws them, and
    ``transformer.params_from_numpy`` copies the reference's in."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        dtype = dtype or torch_dtype(cfg.dtype)
        D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
        H = D // hd
        f32 = torch.float32

        def empty(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.cfg = cfg
        self.ln1 = RMSNorm(D, device)
        self.ln2 = RMSNorm(D, device)
        self.tmix = nn.Module()
        _register(self.tmix,
                  mu=empty(5, D, dt=f32),             # r,k,v,g,w shifts
                  wr=empty(D, D), wk=empty(D, D), wv=empty(D, D),
                  wg=empty(D, D), wo=empty(D, D),
                  w0=empty(H, hd, dt=f32),            # base log-log decay
                  wa=empty(D, LORA_RANK, dt=f32),
                  wb=empty(LORA_RANK, D, dt=f32),
                  u=empty(H, hd, dt=f32))             # bonus
        self.tmix.ln_out = RMSNorm(D, device)
        self.cmix = nn.Module()
        _register(self.cmix,
                  mu=empty(2, D, dt=f32),             # k,r shifts
                  wk=empty(D, Fd), wv=empty(Fd, D), wr=empty(D, D))

    def forward(self, x: torch.Tensor, state: dict | None = None):
        return rwkv_block(self, x, self.cfg, state)


def init_block_(blk: RWKV6Block, gen: torch.Generator) -> RWKV6Block:
    """Draw a block's weights in place, with the reference's distributions
    (``rwkv6.py:rwkv_layer_init``)."""
    tm, cm = blk.tmix, blk.cmix
    with torch.no_grad():
        tm.mu.fill_(0.5)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            dense_init(getattr(tm, name), gen)
        tm.w0.fill_(-1.0)
        dense_init(tm.wa, gen, 0.1)
        dense_init(tm.wb, gen, 0.1)
        tm.u.zero_()
        cm.mu.fill_(0.5)
        for name in ("wk", "wv", "wr"):
            dense_init(getattr(cm, name), gen)
    return blk


def rwkv_layer_init(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device=None) -> RWKV6Block:
    return init_block_(RWKV6Block(cfg, dtype, device), gen)


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (prev carries the last token of the previous
    call; zeros for the first)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _flat(a: torch.Tensor) -> torch.Tensor:
    """(B, T, H, K) -> (B*H, T, K), the kernels' row layout."""
    B, T, H, K = a.shape
    return a.transpose(1, 2).reshape(B * H, T, K)


def _unflat(a: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(B*H, T, K) -> (B, T, H, K)."""
    return a.reshape(B, H, a.shape[1], a.shape[2]).transpose(1, 2)


def wkv_chunked(r, k, v, lw, u, s0, chunk: int, inner_remat: bool = False,
                compute_dtype: torch.dtype = torch.float32):
    """r,k,v,lw: (B, T, H, K); u: (H, K); s0: (B, H, K, V). Returns (o, sT).

    Plain torch on any device.  ``inner_remat`` changes only what a
    backward pass saves (each chunk is recomputed), and ``compute_dtype``
    only the type the big intra-chunk operands are rounded to, as in the
    reference."""
    B, T, H, K = r.shape
    c = min(chunk, T)
    if T % c:  # neutral padding: k=v=r=0 contribute nothing, lw=0 => decay 1
        pad = c - T % c
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
        o, sT = wkv_chunked(r, k, v, lw, u, s0, chunk, inner_remat,
                            compute_dtype)
        return o[:, :T], sT
    o, sT = wkv_forward_plain(_flat(r), _flat(k), _flat(v), _flat(lw),
                              u.repeat(B, 1), s0.reshape(B * H, K, -1),
                              chunk=c, compute_dtype=compute_dtype,
                              remat=inner_remat)
    return _unflat(o, B, H), sT.reshape(B, H, K, -1)


def wkv_recurrent(r, k, v, lw, u, s0):
    """Step-by-step oracle / decode path. Same shapes as wkv_chunked; the
    inputs are upcast to f32 first, as the reference does."""
    B, T, H, K = r.shape
    o, sT = wkv_ref(*(_flat(a).float() for a in (r, k, v, lw)),
                    u.float().repeat(B, 1), s0.reshape(B * H, K, -1))
    return _unflat(o, B, H).to(r.dtype), sT.reshape(B, H, K, -1)


def _wkv(r, kk, vv, lw, u, s0, cfg: ModelConfig):
    """The recurrence on plain tensors, routed as the reference routes it:
    one token the step oracle, else the chunk kernel under
    ``cfg.wkv_use_pallas``, else the plain chunked scan."""
    B, T, H, hd = r.shape
    if T == 1:
        return wkv_recurrent(r, kk, vv, lw, u, s0)
    if cfg.wkv_use_pallas:
        # the chunk kernel, flattened (B, H) -> BH rows with a per-row u
        o_f, s_f = wkv_forward(_flat(r), _flat(kk), _flat(vv), _flat(lw),
                               u.reshape(H, hd).repeat(B, 1),
                               s0.reshape(B * H, hd, hd), cfg.wkv_chunk)
        return _unflat(o_f, B, H), s_f.reshape(B, H, hd, hd)
    return wkv_chunked(r, kk, vv, lw, u, s0, cfg.wkv_chunk,
                       cfg.wkv_inner_remat, torch_dtype(cfg.wkv_compute_dtype))


def _wkv_sharded(r, kk, vv, lw, u, s0, cfg: ModelConfig, ctx: ShardCtx):
    """:func:`_wkv` on a mesh: the heads over the model axis (the
    reference's hints), each rank running the recurrence over its own
    batch rows and heads (the recurrence is per (row, head); DTensor has
    no rule for its flattened (B H) rows).  ``u`` is a weight read alike
    by every batch shard, so its gradient sums over the batch axes."""
    r, kk, vv, lw = (ctx.heads(a) for a in (r, kk, vv, lw))
    s0 = ctx.hint(ctx.replicated(s0), ctx.batch, ctx.model, None, None)
    u = ctx.hint(u, ctx.model, None)
    return ctx.local(lambda *a: _wkv(*a, cfg), r, kk, vv, lw, u, s0,
                     out=(r.placements, s0.placements), summed=(4,))


def rwkv_block(p: RWKV6Block, x: torch.Tensor, cfg: ModelConfig,
               state: dict | None = None, ctx: ShardCtx = NO_MESH):
    """One RWKV6 block. state = {"ts_t","ts_c": (B,D), "s": (B,H,K,V)} for
    decode; None for a fresh sequence (zero-init)."""
    B, T, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    if state is None:
        state = {
            "ts_t": torch.zeros((B, D), dtype=x.dtype, device=x.device),
            "ts_c": torch.zeros((B, D), dtype=x.dtype, device=x.device),
            "s": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=x.device),
        }

    # ---- time mix ----
    tm = p.tmix
    # on a mesh the shift's concatenation runs along an unsharded seq
    xn = ctx.gathered(p.ln1(x, cfg.norm_eps))
    xs = _shift(xn, state["ts_t"])
    mu = tm.mu.to(x.dtype)
    xr, xk, xv, xg, xw = (xn + mu[i] * (xs - xn) for i in range(5))
    r = (xr @ tm.wr).reshape(B, T, H, hd)
    kk = (xk @ tm.wk).reshape(B, T, H, hd)
    vv = (xv @ tm.wv).reshape(B, T, H, hd)
    g = F.silu(xg @ tm.wg)
    # data-dependent decay (the Finch signature): log w = -exp(w0 + lora(x))
    lora = torch.tanh(xw.float() @ tm.wa) @ tm.wb
    lw = -torch.exp(tm.w0.reshape(1, 1, D) + lora).reshape(B, T, H, hd)
    if ctx.mesh is not None and is_dtensor(r):
        o, sT = _wkv_sharded(r, kk, vv, lw, tm.u, state["s"], cfg, ctx)
    else:
        o, sT = _wkv(r, kk, vv, lw, tm.u, state["s"], cfg)
    o = tm.ln_out(o.reshape(B, T, D), cfg.norm_eps) * g
    x = x + ctx.residual(o @ tm.wo)

    # ---- channel mix ----
    cm = p.cmix
    xn2 = ctx.gathered(p.ln2(x, cfg.norm_eps))
    xs2 = _shift(xn2, state["ts_c"])
    cmu = cm.mu.to(x.dtype)
    xk2 = xn2 + cmu[0] * (xs2 - xn2)
    xr2 = xn2 + cmu[1] * (xs2 - xn2)
    kk2 = ctx.hint(torch.square(torch.relu(xk2 @ cm.wk)), ctx.batch, None,
                   ctx.model)
    ffn = torch.sigmoid(xr2 @ cm.wr) * (kk2 @ cm.wv)
    x = x + ctx.residual(ffn)

    new_state = {"ts_t": xn[:, -1, :], "ts_c": xn2[:, -1, :], "s": sT}
    return x, new_state
