"""Model parameters, the training forward (with remat), prefill and cached
decode, port of ``repro.models.transformer`` for all five families
(dense / moe / rwkv6 / rglru_hybrid / encdec).

The reference stacks each layer's parameters along a leading (L, ...) axis
and scans over them; the port holds one model class per family
(``DenseModel``, ``MoEModel``, ``RWKV6Model``, ``RGLRUModel``,
``EncDecModel``) with ``ModuleList``s of layers and loops over them.  A moe
model's ``layers`` hold groups of ``moe_every - 1`` dense layers and one
MoE layer, as the reference's scanned super-layer; an rglru_hybrid model's
``groups`` hold ``rec_per_attn`` recurrent layers and one local-attention
layer, and its ``tail`` the ``n_layers % (rec_per_attn + 1)`` recurrent
layers left over; an encdec model has ``enc_layers`` and ``dec_layers``
(with cross-attention).  Parameter names follow the reference's pytree
(``embed.table``, ``lm_head``, ``frontend.proj``, ``layers.<i>.attn.wq``,
``layers.<g>.dense.<j>.mlp.wi``, ``groups.<g>.recs.<j>.rec.w_x``, ...), so
:func:`params_from_numpy` carries its weights across: every integer in a
name is a stacked index there.

Decode keeps the reference's absolute-position ring-buffer KV cache: the
key of position p lives at slot p % W, ``kpos`` records each slot's
position (-1 for empty), and the mask is computed from positions, so a
sliding window and a full cache share one path.

Every entry point takes the reference's ``ShardCtx`` (``models/layers.py``):
on a ``DeviceMesh`` the model's parameters, the batch and the cache are
DTensors (``models/sharding.py``) and the hints sit where the reference's
do; ``ctx=NO_MESH`` is the one-device path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, NO_MESH, Attention, RMSNorm,
                                       ShardCtx, attention, attn_init_,
                                       dense_init, embed, embed_init,
                                       is_dtensor, kv_proj, mlp, mlp_init_,
                                       unembed)
from repro_torch.models.moe import MoE, moe_ffn, moe_init_
from repro_torch.models.rglru import RGLRU, rglru_block, rglru_layer_init_
from repro_torch.models.rwkv6 import (RWKV6Block, init_block_, rwkv_block,
                                      torch_dtype)

AUX_LOSS_COEF = 0.01


# =============================================================== layers
class DenseLayer(nn.Module):
    """One attention layer (the reference's ``_attn_layer_init``): ``ln1``,
    ``attn``, ``ln2`` and an ``mlp`` or, in a moe model's MoE layer, a
    ``moe``; an encdec decoder layer (``cross``) adds ``ln_x`` and the
    cross-attention ``xattn``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None,
                 moe_layer: bool | None = None, cross: bool = False):
        super().__init__()
        if moe_layer is None:
            moe_layer = cfg.family == "moe"
        D = cfg.d_model
        self.ln1 = RMSNorm(D, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(D, device)
        self.ln_x = RMSNorm(D, device) if cross else None
        self.xattn = Attention(cfg, dtype, device) if cross else None
        self.moe = MoE(cfg, dtype, device) if moe_layer else None
        self.mlp = None if moe_layer else MLP(D, cfg.d_ff, dtype,
                                              cfg.mlp_type, device)

    def init_(self, gen: torch.Generator) -> "DenseLayer":
        attn_init_(self.attn, gen)
        if self.xattn is not None:
            attn_init_(self.xattn, gen)
        if self.moe is not None:
            moe_init_(self.moe, gen)
        else:
            mlp_init_(self.mlp, gen)
        return self


class MoEGroup(nn.Module):
    """One moe super-layer (the reference's ``_moe_group_init``):
    ``moe_every - 1`` dense layers, then one MoE layer (llama4 interleaves
    MoE every other layer)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.dense = nn.ModuleList(
            DenseLayer(cfg, dtype, device, moe_layer=False)
            for _ in range(cfg.moe_every - 1))
        self.moe = DenseLayer(cfg, dtype, device, moe_layer=True)

    def sublayers(self) -> list:
        """In the reference's order (and the cache's ``j`` index)."""
        return [*self.dense, self.moe]

    def init_(self, gen: torch.Generator) -> "MoEGroup":
        for lyr in self.sublayers():
            lyr.init_(gen)
        return self


class RecLayer(nn.Module):
    """One recurrent layer of the rglru_hybrid family (the reference's
    ``_rec_layer_init``): the RG-LRU block ``rec``, then ``ln2`` and a
    SwiGLU ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.rec = RGLRU(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, "swiglu", device)
        self.moe = None

    def init_(self, gen: torch.Generator) -> "RecLayer":
        rglru_layer_init_(self.rec, gen)
        mlp_init_(self.mlp, gen)
        return self


class RGLRUGroup(nn.Module):
    """One rglru_hybrid group (the reference's ``_rglru_group_init``):
    ``rec_per_attn`` recurrent layers under ``recs``, then one local
    attention layer ``attn``, each followed by its own MLP."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.recs = nn.ModuleList(RecLayer(cfg, dtype, device)
                                  for _ in range(cfg.rec_per_attn))
        self.attn = DenseLayer(cfg, dtype, device)

    def init_(self, gen: torch.Generator) -> "RGLRUGroup":
        for lyr in self.recs:
            lyr.init_(gen)
        self.attn.init_(gen)
        return self


# =============================================================== models
class LMModel(nn.Module):
    """What every family shares: ``embed.table``, ``final_norm``,
    ``lm_head`` and, with a modality frontend, ``frontend.proj``; a family
    adds its stacks of layers (:meth:`make_stacks`: ``layers``, or the
    family's own names).  Allocated uninitialised on ``device``
    (:func:`init_params` draws the weights, :func:`params_from_numpy`
    copies the reference's in)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(
            torch.empty((V, D), dtype=dtype, device=device))
        self.final_norm = RMSNorm(D, device)
        self.lm_head = nn.Parameter(
            torch.empty((D, V), dtype=dtype, device=device))
        if cfg.frontend != "none":
            self.frontend = nn.Module()
            self.frontend.proj = nn.Parameter(torch.empty(
                (cfg.frontend_dim, D), dtype=dtype, device=device))
        self.stack_names = []
        for name, lyrs in self.make_stacks(cfg, dtype, device).items():
            setattr(self, name, nn.ModuleList(lyrs))
            self.stack_names.append(name)

    def make_stacks(self, cfg, dtype, device) -> dict:
        """{stack name: its layers}, in the reference's draw order."""
        raise NotImplementedError


class RWKV6Model(LMModel):
    def make_stacks(self, cfg, dtype, device):
        return {"layers": [RWKV6Block(cfg, dtype, device)
                           for _ in range(cfg.n_layers)]}


class DenseModel(LMModel):
    def make_stacks(self, cfg, dtype, device):
        return {"layers": [DenseLayer(cfg, dtype, device)
                           for _ in range(cfg.n_layers)]}


class MoEModel(LMModel):
    def make_stacks(self, cfg, dtype, device):
        if cfg.n_layers % cfg.moe_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"moe_every {cfg.moe_every}")
        return {"layers": [MoEGroup(cfg, dtype, device)
                           for _ in range(cfg.n_layers // cfg.moe_every)]}


class RGLRUModel(LMModel):
    """``groups`` of ``rec_per_attn`` recurrent layers + 1 attention layer
    (12 at 38 layers), then a ``tail`` of ``n_layers % (rec_per_attn +
    1)`` recurrent layers (2 at 38 layers)."""

    def make_stacks(self, cfg, dtype, device):
        n_groups, tail = divmod(cfg.n_layers, cfg.rec_per_attn + 1)
        return {"groups": [RGLRUGroup(cfg, dtype, device)
                           for _ in range(n_groups)],
                "tail": [RecLayer(cfg, dtype, device) for _ in range(tail)]}


class EncDecModel(LMModel):
    """``enc_layers`` (non-causal self-attention) and ``dec_layers``
    (causal self-attention, then cross-attention to the encoder's
    output)."""

    def make_stacks(self, cfg, dtype, device):
        return {"enc_layers": [DenseLayer(cfg, dtype, device)
                               for _ in range(cfg.n_enc_layers)],
                "dec_layers": [DenseLayer(cfg, dtype, device, cross=True)
                               for _ in range(cfg.n_layers)]}


MODELS = {"rwkv6": RWKV6Model, "dense": DenseModel, "moe": MoEModel,
          "rglru_hybrid": RGLRUModel, "encdec": EncDecModel}


def model_class(cfg: ModelConfig) -> type:
    """The family's model class."""
    if cfg.family not in MODELS:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{sorted(MODELS)}")
    return MODELS[cfg.family]


def build_model(cfg: ModelConfig, device=None) -> LMModel:
    """The family's model with uninitialised parameters on ``device``
    (``"meta"`` for shapes only)."""
    return model_class(cfg)(cfg, device)


def _sublayers(cfg: ModelConfig, grp) -> list:
    """A stacked entry's attention layers: a moe group's, in order, or the
    dense layer itself."""
    return grp.sublayers() if cfg.family == "moe" else [grp]


# =============================================================== parameters
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> LMModel:
    """Weights drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, with the reference's distributions (not its numbers)."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _, fill in init_units(model, cfg):
        fill(gen)
    return model


def init_units(model: LMModel, cfg: ModelConfig) -> list:
    """:func:`init_params`' draws in their order: (the name of the parameter
    or layer a draw fills, ``fill(gen)``).  Each ``fill`` reads its
    parameters when called, so a caller may swap them in between (a mesh
    build, ``models/sharding.py::init_sharded_params``).  Norm scales keep
    their constructor's ones and are in no unit."""
    units = [("embed.table", lambda g: embed_init(model.embed.table, g)),
             ("lm_head", lambda g: dense_init(model.lm_head, g))]
    if cfg.frontend != "none":
        units.append(("frontend.proj",
                      lambda g: dense_init(model.frontend.proj, g)))
    for name in model.stack_names:
        for i, lyr in enumerate(getattr(model, name)):
            fill = (functools.partial(init_block_, lyr)
                    if isinstance(lyr, RWKV6Block) else lyr.init_)
            units.append((f"{name}.{i}", fill))
    return units


def reference_key(name: str) -> tuple:
    """(the reference's key path, stacked index) of a port parameter name:
    every integer part is an index of the reference's stacked leaf.
    ``layers.3.tmix.wr`` -> (("layers", "tmix", "wr"), (3,));
    ``layers.1.dense.0.mlp.wi`` -> (("layers", "dense", "mlp", "wi"), (1,
    0)); ``lm_head`` -> (("lm_head",), ())."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def tensor_from_numpy(a) -> torch.Tensor:
    """A leaf of the reference's tree as a tensor: a tensor as it is, an
    array with its dtype."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _stack(by_index: dict) -> torch.Tensor:
    """{index tuple: tensor} -> one tensor stacked along the indices."""
    if () in by_index:
        return by_index[()]
    heads = sorted({i[0] for i in by_index})
    return torch.stack([_stack({i[1:]: t for i, t in by_index.items()
                                if i[0] == h}) for h in heads])


def stack_layers(named) -> dict:
    """A name -> tensor mapping in the reference's layout: nested dicts, the
    layers' leaves stacked (L, ...) under ``layers`` (a moe model's dense
    sub-layers (L / moe_every, moe_every - 1, ...))."""
    by_key = {}
    for name, t in named.items():
        key, index = reference_key(name)
        by_key.setdefault(key, {})[index] = t
    tree = {}
    for key, by_index in by_key.items():
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = _stack(by_index)
    return tree


def params_tree(model: LMModel) -> dict:
    """The model's weights in the reference's ``init_params`` layout (a
    copy: the layers are stacked)."""
    return stack_layers({n: p.detach()
                         for n, p in model.named_parameters()})


def load_params_(model: LMModel, tree: dict) -> LMModel:
    """Copy a tree in the reference's layout (numpy arrays or tensors) into
    ``model``'s parameters: the same numbers in the same dtypes."""
    leaves = dict(_leaves(tree))
    tensors = {}
    for name, param in model.named_parameters():
        key, index = reference_key(name)
        if key not in leaves:
            raise KeyError(f"params_from_numpy: no leaf {'/'.join(key)}")
        if key not in tensors:
            tensors[key] = tensor_from_numpy(leaves[key])
        t = tensors[key][index]
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"params_from_numpy: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, the model wants "
                             f"{tuple(param.shape)} {param.dtype}")
        with torch.no_grad():
            param.copy_(t)
    extra = set(leaves) - set(tensors)
    if extra:
        raise KeyError(f"params_from_numpy: leaves the port does not hold: "
                       f"{sorted('/'.join(k) for k in extra)}")
    return model


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") \
        -> LMModel:
    """The reference's ``init_params`` pytree, as numpy arrays, as the
    port's model on ``device``: the same numbers in the same dtypes.  Layer
    leaves are stacked (L, ...) under ``tree["layers"]``."""
    return load_params_(build_model(cfg, resolve_device(device)), tree)


# =============================================================== inputs
def _embed_inputs(model: LMModel, batch: dict, cfg: ModelConfig,
                  ctx: ShardCtx = NO_MESH):
    """Returns (x (B,S,D), loss_mask (B,S)): the mask is True where the
    next-token loss applies (the text, not the frontend's prefix)."""
    tokens = batch["tokens"]
    x_txt = embed(model.embed.table, tokens, ctx)
    txt = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.frontend == "none" or cfg.family == "encdec":
        # encdec consumes frames in the encoder, not as a decoder prefix
        return ctx.residual(x_txt), txt
    feats = batch["patches"] if cfg.frontend == "vlm_patches" \
        else batch["frames"]
    x_pre = feats.to(x_txt.dtype) @ model.frontend.proj
    mask = torch.zeros(x_pre.shape[:2], dtype=torch.bool,
                       device=tokens.device)
    if ctx.mesh is not None:   # the two parts meet along an unsharded seq
        x_pre = ctx.hint(x_pre, ctx.batch, None, None)
        x_txt = ctx.hint(x_txt, ctx.batch, None, None)
    return ctx.residual(torch.cat([x_pre, x_txt], dim=1)), \
        torch.cat([mask, txt], dim=1)


def _sp_hint(x, ctx: ShardCtx):
    """The reference's Megatron-SP boundary at norm outputs (forward
    all-gather, backward reduce-scatter at this point)."""
    if ctx.mesh is not None and x.shape[1] > 1:
        return ctx.residual(x)
    return x


def _ffn(lyr: DenseLayer, x, cfg: ModelConfig, ctx: ShardCtx = NO_MESH):
    """ln2 + (mlp | moe). Returns (x, aux_loss)."""
    xn = _sp_hint(lyr.ln2(x, cfg.norm_eps), ctx)
    if cfg.family == "moe" and lyr.moe is not None:
        m, aux = moe_ffn(lyr.moe, xn, cfg, ctx)
        return x + m, aux["aux_loss"]
    return x + mlp(lyr.mlp, xn, ctx), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def _dense_layer_train(lyr: DenseLayer, x, cfg: ModelConfig, positions, *,
                       causal: bool = True, window: int | None = None,
                       enc_kv: tuple | None = None, ctx: ShardCtx = NO_MESH):
    """Self-attention (``window``: default cfg.sliding_window), then, with
    ``enc_kv`` = (k, v, kpos, valid) of the encoder's output, the decoder's
    non-causal cross-attention (no RoPE), then the FFN."""
    xn = _sp_hint(lyr.ln1(x, cfg.norm_eps), ctx)
    h, _ = attention(lyr.attn, xn, cfg, ctx=ctx, positions=positions,
                     causal=causal,
                     window=cfg.sliding_window if window is None else window)
    x = x + h
    if enc_kv is not None:
        xc = _sp_hint(lyr.ln_x(x, cfg.norm_eps), ctx)
        hx, _ = attention(lyr.xattn, xc, cfg, ctx=ctx, kv=enc_kv,
                          positions=positions, causal=False, window=0,
                          use_rope=False)
        x = x + hx
    return _ffn(lyr, x, cfg, ctx)


# =============================================================== train forward
def ce_loss(logits, tokens, mask):
    """Next-token CE. logits (B,S,V) f32; predict tokens[:, t+1] at t."""
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1]
    m = (mask[:, 1:] & mask[:, :-1]).float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * m
    return nll.sum() / torch.clamp(m.sum(), min=1.0)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matmuls without batch dimensions (``x @ W`` lowers to
    ``aten.mm``), recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE
            if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy``: "none" a plain call, "nothing"
    recomputes the whole block in the backward pass, "dots" keeps the
    matmul outputs and recomputes the rest."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "nothing":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _ce_loss_sharded(logits, tokens, ctx: ShardCtx):
    """:func:`ce_loss` of a DTensor ``logits`` (B, S, V) (its text the last
    ``S_txt = tokens.shape[1]`` positions, every text position in the loss,
    as every caller's mask says) without gathering the logits: each rank
    sums the loss of its own rows and sequence positions, whose targets it
    reads from the whole (batch-sharded) ``tokens``, and the partial sums
    meet in one all-reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, S, _ = logits.shape
    S_txt = tokens.shape[1]
    off = S - S_txt
    mi = list(ctx.mesh.mesh_dim_names).index(ctx.model)
    seq_sharded = logits.placements[mi] == Shard(1)
    tokens = ctx.hint(tokens, ctx.batch, None)

    def local_nll(lg, tok):
        n = lg.shape[1]
        lo = ctx.model_index() * n if seq_sharded else 0
        t = torch.arange(lo, lo + n, device=lg.device) - off
        m = ((t >= 0) & (t < S_txt - 1)).float()
        tgt = tok[:, torch.clamp(t + 1, 0, S_txt - 1)].long()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        return ((logz - gold) * m).sum()

    out = [Partial() if isinstance(pl, Shard) else Replicate()
           for pl in logits.placements]
    nll = ctx.local(local_nll, logits, tokens, out=out)
    nll = nll.redistribute(ctx.mesh, [Replicate()] * len(out))
    return nll / max(B * (S_txt - 1), 1)


def _loss(logits, tokens, mask, ctx: ShardCtx):
    if ctx.mesh is not None and is_dtensor(logits):
        return _ce_loss_sharded(logits, tokens, ctx)
    S_txt = tokens.shape[1]
    return ce_loss(logits[:, -S_txt:], tokens, mask[:, -S_txt:])


def _rec_layer(lyr: RecLayer, x, cfg: ModelConfig, state=None,
               ctx: ShardCtx = NO_MESH):
    """One recurrent layer: the RG-LRU block, then its FFN.  Returns (x,
    the block's new state)."""
    x, st = rglru_block(lyr.rec, x, cfg, state, ctx)
    return _ffn(lyr, x, cfg, ctx)[0], st


def _encode(model: EncDecModel, frames, cfg: ModelConfig,
            ctx: ShardCtx = NO_MESH):
    """The encoder over ``frames @ frontend.proj`` (non-causal, RoPE),
    normalised by the model's one ``final_norm``, as in the reference.
    Returns (x_enc, its positions, the layers' aux sum)."""
    x = ctx.residual(frames.to(torch_dtype(cfg.dtype)) @ model.frontend.proj)
    pos_e = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(lyr, h, aux):
        h, a = _dense_layer_train(lyr, h, cfg, pos_e, causal=False, ctx=ctx)
        return h, aux + a

    body = _remat(body, cfg)
    for lyr in model.enc_layers:
        x, aux = body(lyr, x, aux)
    return model.final_norm(x, cfg.norm_eps), pos_e, aux


def _forward_train_encdec(model: EncDecModel, batch: dict, cfg: ModelConfig,
                          ctx: ShardCtx = NO_MESH):
    x_enc, pos_e, aux = _encode(model, batch["frames"], cfg, ctx)
    tokens = batch["tokens"]
    x = ctx.residual(embed(model.embed.table, tokens, ctx))
    pos_d = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)

    def body(lyr, h, aux, x_enc):
        # cross-attention keys from the encoder output, projected per layer
        ck, cv = kv_proj(lyr.xattn, x_enc, cfg, pos_e, use_rope=False,
                         ctx=ctx)
        h, a = _dense_layer_train(lyr, h, cfg, pos_d,
                                  enc_kv=(ck, cv, pos_e, None), ctx=ctx)
        return h, aux + a

    body = _remat(body, cfg)
    for lyr in model.dec_layers:
        x, aux = body(lyr, x, aux, x_enc)
    x = model.final_norm(x, cfg.norm_eps)
    loss = _loss(unembed(model.lm_head, x, ctx), tokens,
                 torch.ones(tokens.shape, dtype=torch.bool,
                            device=tokens.device), ctx)
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


def forward_train(model: LMModel, batch: dict, cfg: ModelConfig,
                  ctx: ShardCtx = NO_MESH):
    """Returns (loss, metrics {"ce", "aux"}), a graph for autograd; the
    remat policy wraps one stacked entry (a layer, a moe group, an
    rglru_hybrid group or a tail layer).  aux sums the MoE layers'
    load-balance losses (0 for the other families), and the loss is ce +
    AUX_LOSS_COEF * aux, as in the reference.  An encdec batch carries the
    encoder's ``frames`` beside the decoder's ``tokens``."""
    model_class(cfg)
    if cfg.family == "encdec":
        return _forward_train_encdec(model, batch, cfg, ctx)
    x, mask = _embed_inputs(model, batch, cfg, ctx)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family == "rglru_hybrid":
        def rec_body(lyr, h, aux):
            return _rec_layer(lyr, h, cfg, ctx=ctx)[0], aux

        def group_body(grp, h, aux):
            for lyr in grp.recs:
                h, aux = rec_body(lyr, h, aux)
            h, a = _dense_layer_train(grp.attn, h, cfg, positions,
                                      window=cfg.local_window, ctx=ctx)
            return h, aux + a

        # as in the reference, a group's recurrent layers run inside the
        # group's checkpoint only; each tail layer has its own
        group_body, tail_body = _remat(group_body, cfg), _remat(rec_body, cfg)
        for grp in model.groups:
            x, aux = group_body(grp, x, aux)
        for lyr in model.tail:
            x, aux = tail_body(lyr, x, aux)
    else:
        def body(grp, h, aux):
            if cfg.family == "rwkv6":
                return rwkv_block(grp, h, cfg, ctx=ctx)[0], aux
            for lyr in _sublayers(cfg, grp):
                h, a = _dense_layer_train(lyr, h, cfg, positions, ctx=ctx)
                aux = aux + a
            return h, aux

        body = _remat(body, cfg)
        for grp in model.layers:
            x, aux = body(grp, x, aux)
    x = model.final_norm(x, cfg.norm_eps)
    loss = _loss(unembed(model.lm_head, x, ctx), batch["tokens"], mask, ctx)
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# =============================================================== prefill
def _cache_index(cfg: ModelConfig, i: int, j: int) -> tuple:
    """Where stacked entry i's j-th attention layer keeps its cache slice:
    (i,) in a dense cache (L, B, W, Hkv, hd), (i, j) in a moe cache
    (L / moe_every, moe_every, B, W, Hkv, hd)."""
    return (i, j) if cfg.family == "moe" else (i,)


def _write_slots(buf, at, slots, val, ctx: ShardCtx):
    """``buf[at][:, slots] = val`` (``slots`` None: the whole slice).  A
    DTensor ``buf`` is laid out as ``val`` is (the prefill's write layout,
    :func:`_prefill_layout`), so each rank writes its own shard (DTensor
    has no rule for an indexed write)."""
    def write(b, v):
        if slots is None:
            b[at] = v
        else:
            b[at][:, slots] = v
        return b
    if is_dtensor(buf):
        ctx.local(write, buf, val, out=buf.placements)
    else:
        write(buf, val)


def _prefill_layout(cache: dict, cfg: ModelConfig, ctx: ShardCtx,
                    dev) -> dict:
    """A cache (of meta tensors from :func:`init_cache`) as DTensors in the layout the prefill writes it in,
    each rank allocating only its shard: keys and values (..., B, W, Hkv,
    hd) with B over the batch axes and the kv heads over the model axis
    when they divide it (as ``kv_proj`` makes them); the recurrent states
    as ``cache_specs`` lays them out.  ``kpos`` (-1: empty) and ``pos`` are
    plain tensors on ``dev``, the same on every rank."""
    from torch.distributed.tensor import zeros

    from repro_torch.models.sharding import cache_specs
    specs = cache_specs(cache, ctx.mesh, cfg)
    m = ctx.model if cfg.n_kv_heads % ctx.model_size() == 0 else None
    out = {}
    for nm, t in cache.items():
        if t.dim() <= 1:
            out[nm] = torch.full(t.shape, -1 if nm == "kpos" else 0,
                                 dtype=t.dtype, device=dev)
            continue
        spec = specs[nm]
        if nm in ("k", "v", "ck", "cv"):
            spec = (None,) * (t.dim() - 4) + (ctx.batch, None, m, None)
        out[nm] = zeros(t.shape, dtype=t.dtype, device_mesh=ctx.mesh,
                        placements=ctx.placements(t, spec))
    return out


def _to_cache_layout(cache: dict, cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """The cache redistributed to ``cache_specs``' layout, which decode
    reads (the keys' length dim over the model axis)."""
    from repro_torch.models.sharding import cache_specs
    specs = cache_specs(cache, ctx.mesh, cfg)
    return {nm: ctx.hint(t, *specs[nm]) if is_dtensor(t) else t
            for nm, t in cache.items()}


def _prefill_attn(lyr: DenseLayer, x, cfg: ModelConfig, positions, window,
                  cache, at, slots, m, ctx: ShardCtx = NO_MESH):
    """A prompt's causal self-attention through ``lyr``: writes the last
    ``m`` positions' keys and values at ``slots`` of the cache's slice
    ``at``; returns x + the attention's output."""
    h, (k, v) = attention(lyr.attn, _sp_hint(lyr.ln1(x, cfg.norm_eps), ctx),
                          cfg, ctx=ctx, positions=positions, causal=True,
                          window=window)
    _write_slots(cache["k"], at, slots, k[:, -m:], ctx)
    _write_slots(cache["v"], at, slots, v[:, -m:], ctx)
    return x + h


def forward_prefill(model: LMModel, batch: dict, cfg: ModelConfig,
                    max_len: int | None = None, ctx: ShardCtx = NO_MESH):
    """Process a full prompt, returning (last-token logits (B,V) f32,
    cache).  An attention cache is a ring of width W = cache_window(cfg,
    max_len) (default: the prompt's length) with the key of position p at
    slot p % W; pass max_len > the prompt for generation head-room on full
    attention (a sliding or local window caps W at its width).  The rwkv6
    cache is a fixed-size state and does not use it; the rglru_hybrid
    cache adds each recurrent layer's state, the encdec cache each decoder
    layer's cross-attention keys and values (``ck`` / ``cv``, as many as
    the batch's ``frames``)."""
    model_class(cfg)
    x, _ = _embed_inputs(model, batch, cfg, ctx)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    if cfg.family != "rwkv6":
        ccfg = cfg
        if cfg.family == "encdec":
            x_enc, pos_e, _ = _encode(model, batch["frames"], cfg, ctx)
            ccfg = cfg.replace(frontend_tokens=x_enc.shape[1])
        cache = init_cache(ccfg, B, max_len if max_len is not None else S,
                           device="meta" if ctx.mesh is not None else dev)
        if ctx.mesh is not None:
            cache = _prefill_layout(cache, cfg, ctx, dev)
        W = cache["kpos"].shape[0]
        m = min(W, S)
        slots = (positions[-m:] % W).long()      # the last m positions' slots
        cache["kpos"][slots] = positions[-m:]
    if cfg.family == "rwkv6":
        t1, t2, s = [], [], []
        for blk in model.layers:
            x, st = rwkv_block(blk, x, cfg, ctx=ctx)
            t1.append(st["ts_t"])
            t2.append(st["ts_c"])
            s.append(st["s"])
        cache = {"ts_t": torch.stack(t1), "ts_c": torch.stack(t2),
                 "s": torch.stack(s)}
    elif cfg.family == "rglru_hybrid":
        for g, grp in enumerate(model.groups):
            for j, lyr in enumerate(grp.recs):
                x, st = _rec_layer(lyr, x, cfg, ctx=ctx)
                _write_slots(cache["h"], (g, j), None, st["h"], ctx)
                _write_slots(cache["conv"], (g, j), None, st["conv"], ctx)
            x = _prefill_attn(grp.attn, x, cfg, positions, cfg.local_window,
                              cache, g, slots, m, ctx)
            x, _ = _ffn(grp.attn, x, cfg, ctx)
        for i, lyr in enumerate(model.tail):
            x, st = _rec_layer(lyr, x, cfg, ctx=ctx)
            _write_slots(cache["tail_h"], i, None, st["h"], ctx)
            _write_slots(cache["tail_conv"], i, None, st["conv"], ctx)
    elif cfg.family == "encdec":
        for i, lyr in enumerate(model.dec_layers):
            x = _prefill_attn(lyr, x, cfg, positions, 0, cache, i, slots, m,
                              ctx)
            ck, cv = kv_proj(lyr.xattn, x_enc, cfg, pos_e, use_rope=False,
                             ctx=ctx)
            hx, _ = attention(lyr.xattn,
                              _sp_hint(lyr.ln_x(x, cfg.norm_eps), ctx), cfg,
                              ctx=ctx, kv=(ck, cv, pos_e, None),
                              positions=positions, causal=False, window=0,
                              use_rope=False)
            x, _ = _ffn(lyr, x + hx, cfg, ctx)
            _write_slots(cache["ck"], i, None, ck, ctx)
            _write_slots(cache["cv"], i, None, cv, ctx)
    else:
        for i, grp in enumerate(model.layers):
            for j, lyr in enumerate(_sublayers(cfg, grp)):
                x = _prefill_attn(lyr, x, cfg, positions, cfg.sliding_window,
                                  cache, _cache_index(cfg, i, j), slots, m,
                                  ctx)
                x, _ = _ffn(lyr, x, cfg, ctx)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=dev)
    if ctx.mesh is not None:
        cache = _to_cache_layout(cache, cfg, ctx)
        x = ctx.hint(x, ctx.batch, None, None)   # the last row, unsharded
    # the norm is per row, so the last row alone gives the reference's value
    x = model.final_norm(x[:, -1:, :], cfg.norm_eps)
    return unembed(model.lm_head, x, ctx)[:, 0, :], cache


# =============================================================== decode
def cache_window(cfg: ModelConfig, max_len: int) -> int:
    if cfg.family == "rglru_hybrid":
        return min(cfg.local_window, max_len)
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Zero cache.  rwkv6: per layer, the two token-shift rows and the WKV
    state.  dense / moe: the ring of keys and values in ``cfg.dtype``,
    ``kpos`` (W,) = -1 (empty) and ``pos`` = 0.  rglru_hybrid: a ring per
    group's attention layer (W = min(local_window, max_len)), and per
    recurrent layer ``h`` (f32) and ``conv`` (its last 3 inputs): (G,
    rec_per_attn, B, ...) in the groups, (tail, B, ...) in the tail.
    encdec: the decoder's ring, and ``ck`` / ``cv`` (L, B,
    frontend_tokens, Hkv, hd) for the encoder's keys and values."""
    dev = resolve_device(device)
    model_class(cfg)
    dtype = torch_dtype(cfg.dtype)
    B, L = batch, cfg.n_layers
    if cfg.family == "rwkv6":
        D, K = cfg.d_model, cfg.rwkv_head_dim
        H = D // K
        return {"ts_t": torch.zeros((L, B, D), dtype=dtype, device=dev),
                "ts_c": torch.zeros((L, B, D), dtype=dtype, device=dev),
                "s": torch.zeros((L, B, H, K, K), dtype=torch.float32,
                                 device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    W = cache_window(cfg, max_len)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family == "moe":
        lead = (L // cfg.moe_every, cfg.moe_every)
    elif cfg.family == "rglru_hybrid":
        G, tail = divmod(L, cfg.rec_per_attn + 1)
        lead = (G,)
    else:
        lead = (L,)
    shape = lead + (B, W, Hkv, hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev),
             "kpos": torch.full((W,), -1, dtype=torch.int32, device=dev),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family == "rglru_hybrid":
        Wl = cfg.lru_width or cfg.d_model
        cache["h"] = torch.zeros((G, cfg.rec_per_attn, B, Wl),
                                 dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((G, cfg.rec_per_attn, B, 3, Wl),
                                    dtype=dtype, device=dev)
        if tail:
            cache["tail_h"] = torch.zeros((tail, B, Wl), dtype=torch.float32,
                                          device=dev)
            cache["tail_conv"] = torch.zeros((tail, B, 3, Wl), dtype=dtype,
                                             device=dev)
    elif cfg.family == "encdec":
        S_enc = max(cfg.frontend_tokens, 1)
        for name in ("ck", "cv"):
            cache[name] = torch.zeros((L, B, S_enc, Hkv, hd), dtype=dtype,
                                      device=dev)
    return cache


def _write_ring(buf, slot, val, ctx: ShardCtx):
    """``buf.index_copy_(1, slot, val)`` in place.  On a mesh ``buf`` (B,
    W, Hkv, hd) has its length W over the model axis: ``val`` is gathered
    over that axis and the rank holding the slot writes it, the others
    write back what they hold (a masked write: no rank reads the slot on
    the host)."""
    if not is_dtensor(buf):
        buf.index_copy_(1, slot, val)
        return
    from torch.distributed.tensor import Shard
    mi = list(ctx.mesh.mesh_dim_names).index(ctx.model)
    w_sharded = buf.placements[mi] == Shard(1)
    val = ctx.hint(val, ctx.batch, None, None, None)

    def write(b, v):
        n = b.shape[1]
        ls = slot - (ctx.model_index() * n if w_sharded else 0)
        ok = (ls >= 0) & (ls < n)
        idx = torch.clamp(ls, 0, n - 1)
        b.index_copy_(1, idx, torch.where(ok, v, b.index_select(1, idx)))
        return b

    ctx.local(write, buf, val, out=buf.placements)


def _decode_attn(lyr: DenseLayer, xn, cfg: ModelConfig, ck, cv, kpos, qpos,
                 slot, ctx: ShardCtx = NO_MESH):
    """One-token attention against a layer's ring-buffer slice (B, W, Hkv,
    hd): the new key and value are written at ``slot`` in place, then the
    query attends to every filled slot."""
    k_new, v_new = kv_proj(lyr.attn, xn, cfg, qpos, ctx=ctx)
    _write_ring(ck, slot, k_new, ctx)
    _write_ring(cv, slot, v_new, ctx)
    h, _ = attention(lyr.attn, xn, cfg, ctx=ctx, kv=(ck, cv, kpos, kpos >= 0),
                     positions=qpos, causal=True, window=cfg.sliding_window)
    return h


def forward_decode(model: LMModel, cache: dict, tokens: torch.Tensor,
                   cfg: ModelConfig, ctx: ShardCtx = NO_MESH):
    """One decode step. tokens: (B, 1). Returns (logits (B,V), cache).

    An attention cache's keys and values are updated in place (the
    reference returns new arrays; copying a multi-GB cache every token is
    what a card's KV cache avoids), so the cache passed in is spent: clone
    it first to decode from it twice.  ``kpos`` and ``pos`` are new
    tensors.  The rwkv6 and RG-LRU states are returned new, as in the
    reference; an encdec step reads ``ck`` / ``cv`` and leaves them."""
    model_class(cfg)
    x = ctx.residual(embed(model.embed.table, tokens, ctx))
    pos = cache["pos"]
    if cfg.family == "rwkv6":
        t1, t2, s = [], [], []
        for i, blk in enumerate(model.layers):
            x, st = rwkv_block(blk, x, cfg, state={"ts_t": cache["ts_t"][i],
                                                    "ts_c": cache["ts_c"][i],
                                                    "s": cache["s"][i]},
                               ctx=ctx)
            t1.append(st["ts_t"])
            t2.append(st["ts_c"])
            s.append(st["s"])
        cache = dict(cache, ts_t=torch.stack(t1), ts_c=torch.stack(t2),
                     s=torch.stack(s), pos=pos + 1)
        x = model.final_norm(x, cfg.norm_eps)
        return unembed(model.lm_head, x, ctx)[:, 0, :], cache
    qpos = pos.reshape(1).to(torch.int32)
    slot = (qpos % cache["kpos"].shape[0]).long()
    kpos = cache["kpos"].index_put((slot,), qpos)
    if cfg.family == "rglru_hybrid":
        dcfg = cfg.replace(sliding_window=cfg.local_window)
        new = {name: torch.empty_like(cache[name]) for name in
               ("h", "conv", "tail_h", "tail_conv") if name in cache}
        for g, grp in enumerate(model.groups):
            for j, lyr in enumerate(grp.recs):
                x, st = _rec_layer(lyr, x, cfg, {"h": cache["h"][g, j],
                                                 "conv": cache["conv"][g, j]},
                                   ctx)
                _write_slots(new["h"], (g, j), None, st["h"], ctx)
                _write_slots(new["conv"], (g, j), None, st["conv"], ctx)
            xn = grp.attn.ln1(x, cfg.norm_eps)
            x = x + _decode_attn(grp.attn, xn, dcfg, cache["k"][g],
                                 cache["v"][g], kpos, qpos, slot, ctx)
            x, _ = _ffn(grp.attn, x, cfg, ctx)
        for i, lyr in enumerate(model.tail):
            x, st = _rec_layer(lyr, x, cfg, {"h": cache["tail_h"][i],
                                             "conv": cache["tail_conv"][i]},
                               ctx)
            _write_slots(new["tail_h"], i, None, st["h"], ctx)
            _write_slots(new["tail_conv"], i, None, st["conv"], ctx)
        cache = dict(cache, **new, kpos=kpos, pos=pos + 1)
    elif cfg.family == "encdec":
        S_enc = cache["ck"].shape[2]
        epos = torch.arange(S_enc, dtype=torch.int32, device=x.device)
        for i, lyr in enumerate(model.dec_layers):
            xn = lyr.ln1(x, cfg.norm_eps)
            x = x + _decode_attn(lyr, xn, cfg, cache["k"][i], cache["v"][i],
                                 kpos, qpos, slot, ctx)
            hx, _ = attention(lyr.xattn, lyr.ln_x(x, cfg.norm_eps), cfg,
                              ctx=ctx,
                              kv=(cache["ck"][i], cache["cv"][i], epos, None),
                              positions=qpos, causal=False, window=0,
                              use_rope=False)
            x, _ = _ffn(lyr, x + hx, cfg, ctx)
        cache = dict(cache, kpos=kpos, pos=pos + 1)
    else:
        for i, grp in enumerate(model.layers):
            for j, lyr in enumerate(_sublayers(cfg, grp)):
                at = _cache_index(cfg, i, j)
                xn = lyr.ln1(x, cfg.norm_eps)
                x = x + _decode_attn(lyr, xn, cfg, cache["k"][at],
                                     cache["v"][at], kpos, qpos, slot, ctx)
                x, _ = _ffn(lyr, x, cfg, ctx)
        cache = dict(cache, kpos=kpos, pos=pos + 1)
    x = model.final_norm(x, cfg.norm_eps)
    return unembed(model.lm_head, x, ctx)[:, 0, :], cache
