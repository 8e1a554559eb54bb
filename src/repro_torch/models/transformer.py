"""Model parameters, the training forward (with remat), prefill and cached
decode, port of ``repro.models.transformer`` for the dense, moe and rwkv6
families.

The reference stacks each layer's parameters along a leading (L, ...) axis
and scans over them; the port holds one model class per family
(``DenseModel``, ``MoEModel``, ``RWKV6Model``) with a ``ModuleList`` of
layers and loops over it.  A moe model's list holds groups of
``moe_every - 1`` dense layers and one MoE layer, as the reference's
scanned super-layer.  Parameter names follow the reference's pytree
(``embed.table``, ``lm_head``, ``frontend.proj``, ``layers.<i>.attn.wq``,
``layers.<g>.dense.<j>.mlp.wi``, ...), so :func:`params_from_numpy` carries
its weights across: every integer in a name is a stacked index there.

Decode keeps the reference's absolute-position ring-buffer KV cache: the
key of position p lives at slot p % W, ``kpos`` records each slot's
position (-1 for empty), and the mask is computed from positions, so a
sliding window and a full cache share one path.  The rglru_hybrid and
encdec families raise ``NotImplementedError`` until their slice is ported
(``ROADMAP.md``).
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
from repro_torch.models.layers import (MLP, Attention, RMSNorm, attention,
                                       attn_init_, dense_init, embed,
                                       embed_init, kv_proj, mlp, mlp_init_,
                                       unembed)
from repro_torch.models.moe import MoE, moe_ffn, moe_init_
from repro_torch.models.rwkv6 import (RWKV6Block, init_block_, rwkv_block,
                                      torch_dtype)

AUX_LOSS_COEF = 0.01


# =============================================================== layers
class DenseLayer(nn.Module):
    """One attention layer (the reference's ``_attn_layer_init``): ``ln1``,
    ``attn``, ``ln2`` and an ``mlp`` or, in a moe model's MoE layer, a
    ``moe``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None,
                 moe_layer: bool | None = None):
        super().__init__()
        if moe_layer is None:
            moe_layer = cfg.family == "moe"
        D = cfg.d_model
        self.ln1 = RMSNorm(D, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(D, device)
        self.moe = MoE(cfg, dtype, device) if moe_layer else None
        self.mlp = None if moe_layer else MLP(D, cfg.d_ff, dtype,
                                              cfg.mlp_type, device)

    def init_(self, gen: torch.Generator) -> "DenseLayer":
        attn_init_(self.attn, gen)
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


# =============================================================== models
class LMModel(nn.Module):
    """What every family shares: ``embed.table``, ``final_norm``,
    ``lm_head`` and, with a modality frontend, ``frontend.proj``; a family
    adds its ``layers``.  Allocated uninitialised on ``device``
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
        self.layers = nn.ModuleList(self.make_layers(cfg, dtype, device))

    def make_layers(self, cfg, dtype, device):
        raise NotImplementedError


class RWKV6Model(LMModel):
    def make_layers(self, cfg, dtype, device):
        return [RWKV6Block(cfg, dtype, device) for _ in range(cfg.n_layers)]


class DenseModel(LMModel):
    def make_layers(self, cfg, dtype, device):
        return [DenseLayer(cfg, dtype, device) for _ in range(cfg.n_layers)]


class MoEModel(LMModel):
    def make_layers(self, cfg, dtype, device):
        if cfg.n_layers % cfg.moe_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"moe_every {cfg.moe_every}")
        return [MoEGroup(cfg, dtype, device)
                for _ in range(cfg.n_layers // cfg.moe_every)]


MODELS = {"rwkv6": RWKV6Model, "dense": DenseModel, "moe": MoEModel}


def model_class(cfg: ModelConfig) -> type:
    """The family's model class; a family not ported yet raises."""
    if cfg.family not in MODELS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves "
            f"{sorted(MODELS)} (ROADMAP.md, queue 1)")
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
    embed_init(model.embed.table, gen)
    dense_init(model.lm_head, gen)
    if cfg.frontend != "none":
        dense_init(model.frontend.proj, gen)
    for lyr in model.layers:
        if isinstance(lyr, RWKV6Block):
            init_block_(lyr, gen)
        else:
            lyr.init_(gen)
    return model


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
def _embed_inputs(model: LMModel, batch: dict, cfg: ModelConfig):
    """Returns (x (B,S,D), loss_mask (B,S)): the mask is True where the
    next-token loss applies (the text, not the frontend's prefix)."""
    tokens = batch["tokens"]
    x_txt = embed(model.embed.table, tokens)
    txt = torch.ones_like(tokens, dtype=torch.bool)
    if cfg.frontend == "none":
        return x_txt, txt
    feats = batch["patches"] if cfg.frontend == "vlm_patches" \
        else batch["frames"]
    x_pre = feats.to(x_txt.dtype) @ model.frontend.proj
    mask = torch.zeros(x_pre.shape[:2], dtype=torch.bool,
                       device=tokens.device)
    return torch.cat([x_pre, x_txt], dim=1), torch.cat([mask, txt], dim=1)


def _ffn(lyr: DenseLayer, x, cfg: ModelConfig):
    """ln2 + (mlp | moe). Returns (x, aux_loss)."""
    xn = lyr.ln2(x, cfg.norm_eps)
    if cfg.family == "moe" and lyr.moe is not None:
        m, aux = moe_ffn(lyr.moe, xn, cfg)
        return x + m, aux["aux_loss"]
    return x + mlp(lyr.mlp, xn), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def _dense_layer_train(lyr: DenseLayer, x, cfg: ModelConfig, positions):
    xn = lyr.ln1(x, cfg.norm_eps)
    h, _ = attention(lyr.attn, xn, cfg, positions=positions,
                     window=cfg.sliding_window)
    return _ffn(lyr, x + h, cfg)


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


def forward_train(model: LMModel, batch: dict, cfg: ModelConfig):
    """Returns (loss, metrics {"ce", "aux"}), a graph for autograd; the
    remat policy wraps one stacked entry (a layer, or a moe group).  aux
    sums the MoE layers' load-balance losses (0 for dense and rwkv6), and
    the loss is ce + AUX_LOSS_COEF * aux, as in the reference."""
    model_class(cfg)
    x, mask = _embed_inputs(model, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(grp, h, aux):
        if cfg.family == "rwkv6":
            return rwkv_block(grp, h, cfg)[0], aux
        for lyr in _sublayers(cfg, grp):
            h, a = _dense_layer_train(lyr, h, cfg, positions)
            aux = aux + a
        return h, aux

    body = _remat(body, cfg)
    for grp in model.layers:
        x, aux = body(grp, x, aux)
    x = model.final_norm(x, cfg.norm_eps)
    logits = unembed(model.lm_head, x)
    S_txt = batch["tokens"].shape[1]
    loss = ce_loss(logits[:, -S_txt:], batch["tokens"], mask[:, -S_txt:])
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# =============================================================== prefill
def _cache_index(cfg: ModelConfig, i: int, j: int) -> tuple:
    """Where stacked entry i's j-th attention layer keeps its cache slice:
    (i,) in a dense cache (L, B, W, Hkv, hd), (i, j) in a moe cache
    (L / moe_every, moe_every, B, W, Hkv, hd)."""
    return (i, j) if cfg.family == "moe" else (i,)


def forward_prefill(model: LMModel, batch: dict, cfg: ModelConfig,
                    max_len: int | None = None):
    """Process a full prompt, returning (last-token logits (B,V) f32,
    cache).  An attention cache is a ring of width W = cache_window(cfg,
    max_len) (default: the prompt's length) with the key of position p at
    slot p % W; pass max_len > the prompt for generation head-room on full
    attention (a sliding window caps W at its width).  The rwkv6 cache is
    a fixed-size state and does not use it."""
    model_class(cfg)
    x, _ = _embed_inputs(model, batch, cfg)
    B, S = x.shape[:2]
    dev = x.device
    if cfg.family == "rwkv6":
        t1, t2, s = [], [], []
        for blk in model.layers:
            x, st = rwkv_block(blk, x, cfg)
            t1.append(st["ts_t"])
            t2.append(st["ts_c"])
            s.append(st["s"])
        cache = {"ts_t": torch.stack(t1), "ts_c": torch.stack(t2),
                 "s": torch.stack(s)}
    else:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        cache = init_cache(cfg, B, max_len if max_len is not None else S,
                           device=dev)
        W = cache["kpos"].shape[0]
        m = min(W, S)
        slots = (positions[-m:] % W).long()      # the last m positions' slots
        cache["kpos"][slots] = positions[-m:]
        for i, grp in enumerate(model.layers):
            for j, lyr in enumerate(_sublayers(cfg, grp)):
                xn = lyr.ln1(x, cfg.norm_eps)
                h, (k, v) = attention(lyr.attn, xn, cfg, positions=positions,
                                      causal=True, window=cfg.sliding_window)
                x, _ = _ffn(lyr, x + h, cfg)
                at = _cache_index(cfg, i, j)
                cache["k"][at][:, slots] = k[:, -m:]
                cache["v"][at][:, slots] = v[:, -m:]
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=dev)
    # the norm is per row, so the last row alone gives the reference's value
    x = model.final_norm(x[:, -1:, :], cfg.norm_eps)
    return unembed(model.lm_head, x)[:, 0, :], cache


# =============================================================== decode
def cache_window(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Zero cache.  rwkv6: per layer, the two token-shift rows and the WKV
    state.  dense / moe: the ring of keys and values in ``cfg.dtype``,
    ``kpos`` (W,) = -1 (empty) and ``pos`` = 0."""
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
    lead = ((L // cfg.moe_every, cfg.moe_every) if cfg.family == "moe"
            else (L,))
    shape = lead + (B, W, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "kpos": torch.full((W,), -1, dtype=torch.int32, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _decode_attn(lyr: DenseLayer, xn, cfg: ModelConfig, ck, cv, kpos, qpos,
                 slot):
    """One-token attention against a layer's ring-buffer slice (B, W, Hkv,
    hd): the new key and value are written at ``slot`` in place, then the
    query attends to every filled slot."""
    k_new, v_new = kv_proj(lyr.attn, xn, cfg, qpos)
    ck.index_copy_(1, slot, k_new)
    cv.index_copy_(1, slot, v_new)
    h, _ = attention(lyr.attn, xn, cfg, kv=(ck, cv, kpos, kpos >= 0),
                     positions=qpos, causal=True, window=cfg.sliding_window)
    return h


def forward_decode(model: LMModel, cache: dict, tokens: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step. tokens: (B, 1). Returns (logits (B,V), cache).

    An attention cache's keys and values are updated in place (the
    reference returns new arrays; copying a multi-GB cache every token is
    what a card's KV cache avoids), so the cache passed in is spent: clone
    it first to decode from it twice.  ``kpos`` and ``pos`` are new
    tensors.  The rwkv6 state is returned new, as in the reference."""
    model_class(cfg)
    x = embed(model.embed.table, tokens)
    pos = cache["pos"]
    if cfg.family == "rwkv6":
        t1, t2, s = [], [], []
        for i, blk in enumerate(model.layers):
            x, st = rwkv_block(blk, x, cfg, state={"ts_t": cache["ts_t"][i],
                                                    "ts_c": cache["ts_c"][i],
                                                    "s": cache["s"][i]})
            t1.append(st["ts_t"])
            t2.append(st["ts_c"])
            s.append(st["s"])
        cache = dict(cache, ts_t=torch.stack(t1), ts_c=torch.stack(t2),
                     s=torch.stack(s), pos=pos + 1)
    else:
        qpos = pos.reshape(1).to(torch.int32)
        slot = (qpos % cache["kpos"].shape[0]).long()
        kpos = cache["kpos"].index_put((slot,), qpos)
        for i, grp in enumerate(model.layers):
            for j, lyr in enumerate(_sublayers(cfg, grp)):
                at = _cache_index(cfg, i, j)
                xn = lyr.ln1(x, cfg.norm_eps)
                x = x + _decode_attn(lyr, xn, cfg, cache["k"][at],
                                     cache["v"][at], kpos, qpos, slot)
                x, _ = _ffn(lyr, x, cfg)
        cache = dict(cache, kpos=kpos, pos=pos + 1)
    x = model.final_norm(x, cfg.norm_eps)
    return unembed(model.lm_head, x)[:, 0, :], cache
