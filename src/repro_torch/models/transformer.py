"""Model parameters, the training forward (with remat), prefill and cached
decode, port of ``repro.models.transformer`` for the rwkv6 family.

The reference stacks each layer's parameters along a leading (L, ...) axis
and scans over them; the port holds an ``RWKV6Model`` with a ``ModuleList``
of blocks and loops over it.  Parameter names follow the reference's pytree
(``embed.table``, ``final_norm.scale``, ``lm_head``, ``layers.<i>.tmix.wr``,
...), so :func:`params_from_numpy` can carry its weights across.

Every other family (dense, moe, rglru_hybrid, encdec) raises
``NotImplementedError`` until its slice is ported (``ROADMAP.md``).
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
from repro_torch.models.layers import RMSNorm, embed, embed_init, dense_init, \
    unembed
from repro_torch.models.rwkv6 import (RWKV6Block, init_block_, rwkv_block,
                                      torch_dtype)

AUX_LOSS_COEF = 0.01


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "rwkv6":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves the "
            f"rwkv6 family (ROADMAP.md, queue 1)")


class RWKV6Model(nn.Module):
    """The rwkv6 family's parameters, allocated uninitialised on ``device``
    (:func:`init_params` draws them, :func:`params_from_numpy` copies the
    reference's in)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        if cfg.frontend != "none":
            raise NotImplementedError("modality frontends are not ported "
                                      "yet (ROADMAP.md, queue 1)")
        dtype = torch_dtype(cfg.dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(
            torch.empty((V, D), dtype=dtype, device=device))
        self.final_norm = RMSNorm(D, device)
        self.lm_head = nn.Parameter(
            torch.empty((D, V), dtype=dtype, device=device))
        self.layers = nn.ModuleList(
            RWKV6Block(cfg, dtype, device) for _ in range(cfg.n_layers))


# =============================================================== parameters
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> RWKV6Model:
    """Weights drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, with the reference's distributions (not its numbers)."""
    dev = resolve_device(device)
    model = RWKV6Model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed_init(model.embed.table, gen)
    dense_init(model.lm_head, gen)
    for blk in model.layers:
        init_block_(blk, gen)
    return model


def reference_key(name: str) -> tuple:
    """(the reference's key path, layer index or None) of a port parameter
    name: ``layers.3.tmix.wr`` -> (("layers", "tmix", "wr"), 3); the
    reference stacks the layers' leaves (L, ...) under ``layers``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


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


def stack_layers(named) -> dict:
    """A name -> tensor mapping in the reference's layout: nested dicts, the
    layers' leaves stacked (L, ...) under ``layers``."""
    leaves, layers = {}, {}
    for name, t in named.items():
        key, index = reference_key(name)
        if index is None:
            leaves[key] = t
        else:
            layers.setdefault(key, {})[index] = t
    for key, by_index in layers.items():
        leaves[key] = torch.stack([by_index[i] for i in sorted(by_index)])
    tree = {}
    for key, t in leaves.items():
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = t
    return tree


def params_tree(model: RWKV6Model) -> dict:
    """The model's weights in the reference's ``init_params`` layout (a
    copy: the layers are stacked)."""
    return stack_layers({n: p.detach()
                         for n, p in model.named_parameters()})


def load_params_(model: RWKV6Model, tree: dict) -> RWKV6Model:
    """Copy a tree in the reference's layout (numpy arrays or tensors) into
    ``model``'s parameters: the same numbers in the same dtypes."""
    leaves = dict(_leaves(tree))
    seen = set()
    for name, param in model.named_parameters():
        key, index = reference_key(name)
        if key not in leaves:
            raise KeyError(f"params_from_numpy: no leaf {'/'.join(key)}")
        seen.add(key)
        t = tensor_from_numpy(leaves[key])
        if index is not None:
            t = t[index]
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"params_from_numpy: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, the model wants "
                             f"{tuple(param.shape)} {param.dtype}")
        with torch.no_grad():
            param.copy_(t)
    extra = set(leaves) - seen
    if extra:
        raise KeyError(f"params_from_numpy: leaves the port does not hold: "
                       f"{sorted('/'.join(k) for k in extra)}")
    return model


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") \
        -> RWKV6Model:
    """The reference's ``init_params`` pytree, as numpy arrays, as the
    port's model on ``device``: the same numbers in the same dtypes.  Layer
    leaves are stacked (L, ...) under ``tree["layers"]``."""
    return load_params_(RWKV6Model(cfg, resolve_device(device)), tree)


# =============================================================== inputs
def _embed_inputs(model: RWKV6Model, batch: dict, cfg: ModelConfig):
    """Returns (x (B,S,D), loss_mask (B,S)); text only."""
    tokens = batch["tokens"]
    return embed(model.embed.table, tokens), torch.ones_like(tokens,
                                                             dtype=torch.bool)


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


def forward_train(model: RWKV6Model, batch: dict, cfg: ModelConfig):
    """Returns (loss, metrics {"ce", "aux"}), a graph for autograd.  The
    rwkv6 family has no auxiliary loss, so aux is 0, as in the
    reference."""
    check_family(cfg)
    x, mask = _embed_inputs(model, batch, cfg)
    body = _remat(lambda blk, h: rwkv_block(blk, h, cfg)[0], cfg)
    for blk in model.layers:
        x = body(blk, x)
    x = model.final_norm(x, cfg.norm_eps)
    logits = unembed(model.lm_head, x)
    S_txt = batch["tokens"].shape[1]
    loss = ce_loss(logits[:, -S_txt:], batch["tokens"], mask[:, -S_txt:])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# =============================================================== prefill
def forward_prefill(model: RWKV6Model, batch: dict, cfg: ModelConfig,
                    max_len: int | None = None):
    """Process a full prompt, returning (last-token logits (B,V) f32,
    cache).  ``max_len`` sizes attention caches in the reference; the
    rwkv6 cache is a fixed-size state and does not use it."""
    check_family(cfg)
    x, _ = _embed_inputs(model, batch, cfg)
    S = x.shape[1]
    t1, t2, s = [], [], []
    for blk in model.layers:
        x, st = rwkv_block(blk, x, cfg)
        t1.append(st["ts_t"])
        t2.append(st["ts_c"])
        s.append(st["s"])
    cache = {"ts_t": torch.stack(t1), "ts_c": torch.stack(t2),
             "s": torch.stack(s),
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    # the norm is per row, so the last row alone gives the reference's value
    x = model.final_norm(x[:, -1:, :], cfg.norm_eps)
    return unembed(model.lm_head, x)[:, 0, :], cache


# =============================================================== decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Zero cache: per layer, the two token-shift rows and the WKV state."""
    dev = resolve_device(device)
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    L, D, K = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    H = D // K
    return {"ts_t": torch.zeros((L, batch, D), dtype=dtype, device=dev),
            "ts_c": torch.zeros((L, batch, D), dtype=dtype, device=dev),
            "s": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                             device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def forward_decode(model: RWKV6Model, cache: dict, tokens: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step. tokens: (B, 1). Returns (logits (B,V), cache)."""
    check_family(cfg)
    x = embed(model.embed.table, tokens)
    t1, t2, s = [], [], []
    for i, blk in enumerate(model.layers):
        x, st = rwkv_block(blk, x, cfg, state={"ts_t": cache["ts_t"][i],
                                                "ts_c": cache["ts_c"][i],
                                                "s": cache["s"][i]})
        t1.append(st["ts_t"])
        t2.append(st["ts_c"])
        s.append(st["s"])
    cache = dict(cache, ts_t=torch.stack(t1), ts_c=torch.stack(t2),
                 s=torch.stack(s), pos=cache["pos"] + 1)
    x = model.final_norm(x, cfg.norm_eps)
    return unembed(model.lm_head, x)[:, 0, :], cache
