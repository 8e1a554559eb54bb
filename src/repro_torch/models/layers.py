"""Shared transformer layers, port of ``repro.models.layers``: RMSNorm,
RoPE, GQA attention (full / sliding window / KV-cache decode, query
chunks), the SwiGLU and GELU MLPs, dense and embedding initialisers, the
embedding lookup and the f32 unembedding.

The reference threads sharding hints through ``ShardCtx``; the port has no
mesh, so it has no counterpart and the hints are dropped.  The reference's
parameter dicts are ``nn.Module``s here with the same names (``wq``,
``bq``, ``wi``, ``wg``, ...), so ``p["wq"]`` reads ``p.wq``.

Initialisers draw from an explicit ``torch.Generator`` with the reference's
distributions (not its numbers: ``jax.random`` and torch draw differently;
``transformer.params_from_numpy`` carries the reference's own weights
across).  Each fills a tensor the caller allocated, so a model is built on
its device without a copy on the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig


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


def normal_(w: torch.Tensor, gen: torch.Generator,
            std: float) -> torch.Tensor:
    """Fill ``w`` with N(0, 1) * std, drawn in f32 and cast to w's
    dtype."""
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device).mul_(std))
    return w


def dense_init(w: torch.Tensor, gen: torch.Generator,
               scale: float = 1.0) -> torch.Tensor:
    """Fill ``w`` (d_in, d_out) with N(0, 1) * scale / sqrt(d_in)."""
    return normal_(w, gen, scale * (w.shape[0] ** -0.5))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int absolute positions.
    The half-split layout (first half rotated against the second), angles
    in f32, the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs             # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None):
    """``x @ w + b`` as the reference writes it (two roundings in bf16, not
    one fused ``addmm``)."""
    y = x @ w
    return y if b is None else y + b


# ---------------------------------------------------------------- attention
class Attention(nn.Module):
    """One attention block's parameters (the reference's ``attn_init``
    dict): ``wq`` (D, Hq hd), ``wk`` / ``wv`` (D, Hkv hd), ``wo`` (Hq hd,
    D) and, with ``cfg.qkv_bias``, ``bq`` / ``bk`` / ``bv``.  Allocated
    uninitialised; :func:`attn_init_` draws them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        hd, Hq, Hkv, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model

        def par(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.wq, self.wk = par(D, Hq * hd), par(D, Hkv * hd)
        self.wv, self.wo = par(D, Hkv * hd), par(Hq * hd, D)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = par(Hq * hd), par(Hkv * hd), \
                par(Hkv * hd)
        else:
            self.bq = self.bk = self.bv = None


def attn_init_(p: Attention, gen: torch.Generator) -> Attention:
    for name in ("wq", "wk", "wv", "wo"):
        dense_init(getattr(p, name), gen)
    with torch.no_grad():
        for b in (p.bq, p.bk, p.bv):
            if b is not None:
                b.zero_()
    return p


def kv_proj(p: Attention, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, use_rope: bool = True):
    """Project x to (k, v) heads (B, S, Hkv, hd), applying RoPE at absolute
    ``positions``: the cache stores post-RoPE keys, so decode never
    re-rotates history."""
    B, S, _ = x.shape
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    k = _linear(x, p.wk, p.bk).reshape(B, S, Hkv, hd)
    v = _linear(x, p.wv, p.bv).reshape(B, S, Hkv, hd)
    if use_rope:
        k = rope(k, positions[None], cfg.rope_theta)
    return k, v


def _scores_mask(qpos, kpos, *, causal: bool, window: int):
    """(Sq, Sk) boolean mask: True = attend."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > (qpos[:, None] - window)
    return ok


def _sdpa(q, k, v, qpos, kpos, kv_valid, *, causal, window):
    """q: (B, Sq, Hq, hd); k / v: (B, Sk, Hkv, hd) with Hq = G Hkv: query
    head h reads kv head h // G, the reference's ``jnp.repeat(k, G,
    axis=2)``, here a (Hkv, G) view of the query heads instead of G copies
    of k and v.  The scores are f32 from q and k upcast (the reference's
    ``preferred_element_type=f32``: bf16 products are exact in f32, and
    nothing is rounded to bf16 before the softmax); masked entries -1e30,
    the softmax in f32, the weights cast to v's dtype for the value
    product."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) \
        * (hd ** -0.5)
    mask = _scores_mask(qpos, kpos, causal=causal, window=window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, hd)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              kv: tuple | None = None, positions: torch.Tensor | None = None,
              causal: bool = True, window: int = 0, use_rope: bool = True):
    """x: (B, Sq, D).  ``kv`` = (k, v, kpos, kv_valid) for decode / cross
    attention; ``positions`` (Sq,) absolute positions.  Returns (out (B, Sq,
    D), (k, v)).

    Queries go in chunks of ``cfg.attn_q_chunk`` when Sq is a larger
    multiple of it (each chunk's f32 scores recomputed in the backward pass
    under ``cfg.attn_chunk_remat``), else in one piece, as in the
    reference."""
    B, Sq, _ = x.shape
    hd, Hq = cfg.hd, cfg.n_heads
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32, device=x.device)
    q = _linear(x, p.wq, p.bq).reshape(B, Sq, Hq, hd)
    if kv is None:
        k, v = kv_proj(p, x, cfg, positions, use_rope)
        kpos, kv_valid = positions, None
    else:
        k, v, kpos, kv_valid = kv
    if use_rope:
        q = rope(q, positions[None], cfg.rope_theta)

    def one_chunk(qc_, pc_):
        return _sdpa(qc_, k, v, pc_, kpos, kv_valid, causal=causal,
                     window=window)

    qc = cfg.attn_q_chunk
    if Sq > qc and Sq % qc == 0:
        if cfg.attn_chunk_remat and torch.is_grad_enabled():
            chunk = lambda a, b: checkpoint(one_chunk, a, b,   # noqa: E731
                                            use_reentrant=False)
        else:
            chunk = one_chunk
        o = torch.cat([chunk(q[:, i:i + qc], positions[i:i + qc])
                       for i in range(0, Sq, qc)], dim=1)
    else:
        o = one_chunk(q, positions)
    return o.reshape(B, Sq, Hq * hd) @ p.wo, (k, v)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``wi`` (d, f), ``wo`` (f, d) and, for SwiGLU, the gate ``wg`` (d,
    f).  Allocated uninitialised; :func:`mlp_init_` draws them."""

    def __init__(self, d: int, f: int, dtype: torch.dtype,
                 mlp_type: str = "swiglu", device=None):
        super().__init__()

        def par(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.wi = par(d, f)
        self.wg = par(d, f) if mlp_type == "swiglu" else None
        self.wo = par(f, d)


def mlp_init_(p: MLP, gen: torch.Generator) -> MLP:
    """The reference's draw order: wi, wg (SwiGLU), wo."""
    for w in (p.wi, p.wg, p.wo):
        if w is not None:
            dense_init(w, gen)
    return p


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    if p.wg is not None:       # SwiGLU
        h = F.silu(x @ p.wg) * (x @ p.wi)
    else:                      # GELU (gpt-bigcode / granite): jax.nn.gelu's
        h = F.gelu(x @ p.wi, approximate="tanh")      # default, tanh
    return h @ p.wo
