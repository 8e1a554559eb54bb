"""Model parameters, prefill and cached decode, port of
``repro.models.transformer`` for the rwkv6 family.

The reference stacks each layer's parameters along a leading (L, ...) axis
and scans over them; the port holds an ``RWKV6Model`` with a ``ModuleList``
of blocks and loops over it.  Parameter names follow the reference's pytree
(``embed.table``, ``final_norm.scale``, ``lm_head``, ``layers.<i>.tmix.wr``,
...), so :func:`params_from_numpy` can carry its weights across.

Every other family (dense, moe, rglru_hybrid, encdec) raises
``NotImplementedError`` until its slice is ported (``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, embed, embed_init, dense_init, \
    unembed
from repro_torch.models.rwkv6 import (RWKV6Block, init_block_, rwkv_block,
                                      torch_dtype)


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


def _tensor(a) -> torch.Tensor:
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


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") \
        -> RWKV6Model:
    """The reference's ``init_params`` pytree, as numpy arrays, as the
    port's model on ``device``: the same numbers in the same dtypes.  Layer
    leaves are stacked (L, ...) under ``tree["layers"]``."""
    dev = resolve_device(device)
    model = RWKV6Model(cfg, dev)
    leaves = dict(_leaves(tree))
    seen = set()
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key, index = ("layers",) + tuple(parts[2:]), int(parts[1])
        else:
            key, index = tuple(parts), None
        if key not in leaves:
            raise KeyError(f"params_from_numpy: no leaf {'/'.join(key)}")
        seen.add(key)
        t = _tensor(leaves[key])
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


# =============================================================== prefill
def _embed_inputs(model: RWKV6Model, batch: dict, cfg: ModelConfig):
    """Returns (x (B,S,D), loss_mask (B,S)); text only."""
    tokens = batch["tokens"]
    return embed(model.embed.table, tokens), torch.ones_like(tokens,
                                                             dtype=torch.bool)


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
