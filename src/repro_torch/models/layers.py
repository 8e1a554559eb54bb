"""Shared transformer layers, port of ``repro.models.layers``: RMSNorm,
RoPE, GQA attention (full / sliding window / KV-cache decode, query
chunks), the SwiGLU and GELU MLPs, dense and embedding initialisers, the
embedding lookup and the f32 unembedding.

Sharding is threaded through :class:`ShardCtx`, as in the reference: with a
``DeviceMesh`` the parameters and activations are DTensors, ``hint``
redistributes an activation to a spec's placements (the reference's
``with_sharding_constraint``), and the blocks DTensor has no sharding rule
for run on each rank's local shards (:meth:`ShardCtx.local`, over
``local_map``).  With ``mesh=None`` every hint is the identity and the
code is the one-device path.  The reference's parameter dicts are ``nn.Module``s here with the same names (``wq``,
``bq``, ``wi``, ``wg``, ...), so ``p["wq"]`` reads ``p.wq``.

Initialisers draw from an explicit ``torch.Generator`` with the reference's
distributions (not its numbers: ``jax.random`` and torch draw differently;
``transformer.params_from_numpy`` carries the reference's own weights
across).  Each fills a tensor the caller allocated, so a model is built on
its device without a copy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (axis_sizes, fix_divisibility,
                                         is_dtensor, to_placements)


# ---------------------------------------------------------------- sharding

@dataclass(frozen=True)
class ShardCtx:
    """Activation-sharding hints. ``batch`` axes shard the batch dim,
    ``model`` shards heads / ffn / vocab / (optionally) sequence.  Specs
    are the reference's (see ``models/sharding.py``); an axis that does not
    divide its dim is dropped, so nothing is sharded unevenly."""

    mesh: object = None
    batch: tuple = ("data",)
    model: str = "model"
    seq_shard: bool = True  # Megatron-style sequence parallelism on residuals

    def placements(self, x, spec) -> list:
        return to_placements(fix_divisibility(tuple(spec), x.shape, self.mesh),
                             self.mesh)

    def hint(self, x, *spec):
        """``x`` redistributed to ``spec``; the identity without a mesh or
        on a plain tensor."""
        if self.mesh is None or not is_dtensor(x):
            return x
        pl = self.placements(x, spec)
        if list(x.placements) == pl:
            return x
        return x.redistribute(self.mesh, pl)

    def replicated(self, t):
        """A plain tensor that every rank holds whole (a zero state, a
        position vector) as a replicated DTensor, with no communication;
        a DTensor as it is."""
        if is_dtensor(t):
            return t
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(t, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def pin(self, x, *spec):
        """:meth:`hint` that lays the gradient out as ``spec`` too, even
        where the forward is already so laid out (a reshape's backward
        must not see a gradient split inside a head)."""
        if self.mesh is None or not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.placements(x, spec))

    def residual(self, x):
        """(B, S, D) residual stream: batch over dp, optionally seq over
        tp."""
        if self.mesh is None:
            return x
        seq = self.model if self.seq_shard else None
        return self.hint(x, self.batch, seq, None)

    def gathered(self, x):
        """(B, S, D) with only the batch sharded: Megatron-SP's all-gather
        of a sequence-sharded activation before a product with a weight
        (DTensor's matmul rule fails on a (B S) row dim sharded over two
        mesh axes)."""
        return self.hint(x, self.batch, None, None)

    def heads(self, x):
        """(B, S, H, hd): heads over tp."""
        return self.hint(x, self.batch, None, self.model, None)

    def model_index(self) -> int:
        """This rank's coordinate on the model axis."""
        return self.mesh.get_local_rank(self.model)

    def model_size(self) -> int:
        return axis_sizes(self.mesh)[self.model]

    def local(self, fn, *args, out, summed=()):
        """``fn`` on the local shards of its DTensor arguments (plain
        arguments pass as they are), through ``local_map``: its outputs
        are wrapped as DTensors with the placements ``out`` (one list of
        placements, or a tuple of them for several outputs).  The caller guarantees that ``fn`` is local:
        each rank's outputs depend only on its own shards.  An input's
        gradient then has the input's placements, except for the inputs at
        the indices ``summed`` (a weight every shard reads): on the mesh
        dims where another input is sharded, their gradient is a partial
        sum (``local_map``'s ``in_grad_placements``)."""
        from torch.distributed.tensor import Partial, Placement, Replicate
        from torch.distributed.tensor.experimental import local_map
        varying = {i for a in args if is_dtensor(a)
                   for i, pl in enumerate(a.placements)
                   if not isinstance(pl, Replicate)}

        def grad_pl(j, a):
            if not is_dtensor(a):
                return None
            if j not in summed:
                return a.placements
            return [Partial() if i in varying and isinstance(pl, Replicate)
                    else pl for i, pl in enumerate(a.placements)]

        if all(isinstance(pl, Placement) for pl in out):
            out_pl = list(out)
        else:
            out_pl = tuple(list(o) for o in out)
        return local_map(fn, out_placements=out_pl,
                         in_grad_placements=[grad_pl(j, a) for j, a in
                                             enumerate(args)],
                         device_mesh=self.mesh)(*args)


NO_MESH = ShardCtx()


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


def embed(table: torch.Tensor, tokens: torch.Tensor,
          ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    if ctx.mesh is not None and is_dtensor(table):
        # the table gathered whole, each rank looking up its own batch rows
        # (DTensor has no rule for indexing with a sharded index, and its
        # vocab-parallel embedding rule fails on batch-sharded tokens)
        tokens = ctx.hint(ctx.replicated(tokens), ctx.batch,
                          *(None,) * (tokens.dim() - 1))
        return ctx.local(lambda t, i: t[i], ctx.hint(table, None, None),
                         tokens, out=tokens.placements, summed=(0,))
    return table[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor,
            ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    """Logits in f32 from lm_head w (D, V), sequence-sharded on a mesh (the
    reference's DESIGN §6: the (B, S, V) tensor is the largest activation
    for 150k vocabs; keeping it seq-sharded over the model axis makes the
    CE parallel)."""
    logits = ctx.gathered(x).float() @ w.float()
    if ctx.mesh is not None:
        seq = ctx.model if ctx.seq_shard else None
        logits = ctx.hint(logits, ctx.batch, seq, None)
    return logits


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


def _split_heads(t: torch.Tensor, n_heads: int, ctx: ShardCtx):
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd); on a mesh the heads go
    over the model axis first (whole heads: an axis that does not divide
    ``n_heads`` is dropped)."""
    B, S, _ = t.shape
    if ctx.mesh is not None and is_dtensor(t):
        m = ctx.model if n_heads % ctx.model_size() == 0 else None
        t = ctx.hint(t, ctx.batch, None, m)
    return t.reshape(B, S, n_heads, -1)


def kv_proj(p: Attention, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, use_rope: bool = True,
            ctx: ShardCtx = NO_MESH):
    """Project x to (k, v) heads (B, S, Hkv, hd), applying RoPE at absolute
    ``positions``: the cache stores post-RoPE keys, so decode never
    re-rotates history."""
    Hkv = cfg.n_kv_heads
    x = ctx.gathered(x)
    k = _split_heads(_linear(x, p.wk, p.bk), Hkv, ctx)
    v = _split_heads(_linear(x, p.wv, p.bv), Hkv, ctx)
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


def _masked_scores(q, k, qpos, kpos, kv_valid, *, causal, window):
    """(B, Hkv, G, Sq, Sk) f32 scores of q: (B, Sq, Hq, hd) against k:
    (B, Sk, Hkv, hd), Hq = G Hkv, query head h reading kv head h // G;
    q and k upcast, scaled by hd^-1/2, masked entries -1e30."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) \
        * (hd ** -0.5)
    mask = _scores_mask(qpos, kpos, causal=causal, window=window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    return torch.where(mask, s, -1e30)


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
    s = _masked_scores(q, k, qpos, kpos, kv_valid, causal=causal,
                       window=window)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, hd)


def _attend(q, k, v, positions, kpos, kv_valid, cfg: ModelConfig, *,
            causal: bool, window: int):
    """The attention core on plain tensors: queries in chunks of
    ``cfg.attn_q_chunk`` when Sq is a larger multiple of it (each chunk's
    f32 scores recomputed in the backward pass under
    ``cfg.attn_chunk_remat``), else in one piece, as in the reference."""
    Sq = q.shape[1]

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
        return torch.cat([chunk(q[:, i:i + qc], positions[i:i + qc])
                          for i in range(0, Sq, qc)], dim=1)
    return one_chunk(q, positions)


def _decode_sharded(q, k, v, qpos, kpos, kv_valid, ctx: ShardCtx, *,
                    causal: bool, window: int):
    """One query position against a cache whose length W lies over the
    model axis (``cache_specs``; the reference's flash-decode layout): each
    rank scores its own slots, and the softmax's max and sum and the value
    product meet in three all-reduces over that axis (of the scores' max,
    their exponentials' sum, and the partial outputs), the softmax of
    :func:`_sdpa` with its sums split across ranks.  ``kpos`` and
    ``kv_valid`` are whole (W,) on every rank.  Serving only: no
    backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ctx.mesh
    q = ctx.hint(q, ctx.batch, None, None, None)
    k = ctx.hint(k, ctx.batch, ctx.model, None, None)
    v = ctx.hint(v, ctx.batch, ctx.model, None, None)
    mi = list(mesh.mesh_dim_names).index(ctx.model)
    w_sharded = k.placements[mi] == Shard(1)
    q_l, k_l, v_l = q.to_local(), k.to_local(), v.to_local()
    B, _, Hq, hd = q_l.shape
    n = k_l.shape[1]
    lo = ctx.model_index() * n if w_sharded else 0
    s = _masked_scores(q_l, k_l, qpos, kpos[lo:lo + n],
                       None if kv_valid is None else kv_valid[lo:lo + n],
                       causal=causal, window=window)

    def over_model(t, op):
        """``t``'s ``op`` over the model axis (the identity when the
        cache's length is not sharded there)."""
        if not w_sharded:
            return t
        pl = [Replicate()] * mesh.ndim
        src = list(pl)
        src[mi] = Partial(op)
        return DTensor.from_local(t, mesh, src, run_check=False) \
            .redistribute(mesh, pl).to_local()

    e = torch.exp(s - over_model(s.amax(-1, keepdim=True), "max"))
    w = e / over_model(e.sum(-1, keepdim=True), "sum")
    o = over_model(torch.einsum("bkgqt,btkd->bqkgd", w.to(v_l.dtype), v_l),
                   "sum")
    return DTensor.from_local(o.reshape(B, 1, Hq, hd), mesh, q.placements,
                              run_check=False)


def _attend_sharded(q, k, v, positions, kpos, kv_valid, cfg: ModelConfig,
                    ctx: ShardCtx, *, causal: bool, window: int):
    """:func:`_attend` on a mesh.  Train / prefill (Sq > 1): the heads go
    over the model axis (the reference's hints) and each rank attends its
    own heads on its own batch rows (DTensor has no rule for the grouped
    einsum over a batch and a head dim sharded on two mesh axes).  With
    the query heads sharded and the kv heads not (Hkv not a multiple of the
    axis), a rank takes the kv heads its query heads read, the reference's
    ``jnp.repeat(k, G, axis=2)`` restricted to its heads.  Decode (Sq = 1):
    :func:`_decode_sharded`."""
    Sq, Hq = q.shape[1], q.shape[2]
    if Sq == 1:
        return _decode_sharded(q, k, v, positions, kpos, kv_valid, ctx,
                               causal=causal, window=window)
    m = ctx.model_size()
    k = ctx.hint(k, ctx.batch, None,
                 ctx.model if k.shape[2] % m == 0 else None, None)
    v = ctx.hint(v, ctx.batch, None,
                 ctx.model if v.shape[2] % m == 0 else None, None)
    q = ctx.heads(q)
    G = Hq // k.shape[2]
    h0 = ctx.model_index() * (Hq // m) if Hq % m == 0 else 0
    kv_sharded = k.shape[2] % m == 0

    def core(q_l, k_l, v_l):
        if not kv_sharded and q_l.shape[2] != Hq:
            idx = torch.div(torch.arange(h0, h0 + q_l.shape[2],
                                         device=k_l.device), G,
                            rounding_mode="floor")
            k_l, v_l = k_l[:, :, idx], v_l[:, :, idx]
        return _attend(q_l, k_l, v_l, positions, kpos, kv_valid, cfg,
                       causal=causal, window=window)

    # kv heads replicated over the model axis are read by several ranks'
    # query heads: their gradient sums over that axis
    return ctx.local(core, q, k, v, out=q.placements, summed=(1, 2))


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              ctx: ShardCtx = NO_MESH, kv: tuple | None = None,
              positions: torch.Tensor | None = None, causal: bool = True,
              window: int = 0, use_rope: bool = True):
    """x: (B, Sq, D).  ``kv`` = (k, v, kpos, kv_valid) for decode / cross
    attention; ``positions`` (Sq,) absolute positions.  Returns (out (B, Sq,
    D), (k, v))."""
    B, Sq, _ = x.shape
    hd, Hq = cfg.hd, cfg.n_heads
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32, device=x.device)
    x = ctx.gathered(x)
    q = _split_heads(_linear(x, p.wq, p.bq), Hq, ctx)
    if kv is None:
        k, v = kv_proj(p, x, cfg, positions, use_rope, ctx)
        kpos, kv_valid = positions, None
    else:
        k, v, kpos, kv_valid = kv
    if use_rope:
        q = rope(q, positions[None], cfg.rope_theta)
    if ctx.mesh is not None and is_dtensor(q):
        o = _attend_sharded(q, k, v, positions, kpos, kv_valid, cfg, ctx,
                            causal=causal, window=window)
    else:
        o = _attend(q, k, v, positions, kpos, kv_valid, cfg, causal=causal,
                    window=window)
    o = o.reshape(B, Sq, Hq * hd)
    if ctx.mesh is not None:
        o = ctx.pin(o, ctx.batch, None,
                    ctx.model if Hq % ctx.model_size() == 0 else None)
    return ctx.residual(o @ p.wo), (k, v)


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


def mlp(p: MLP, x: torch.Tensor, ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    x = ctx.gathered(x)
    if p.wg is not None:       # SwiGLU
        h = F.silu(x @ p.wg) * (x @ p.wi)
    else:                      # GELU (gpt-bigcode / granite): jax.nn.gelu's
        h = F.gelu(x @ p.wi, approximate="tanh")      # default, tanh
    h = ctx.hint(h, ctx.batch, None, ctx.model)
    return ctx.residual(h @ p.wo)
