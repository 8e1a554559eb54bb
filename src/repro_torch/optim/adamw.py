"""AdamW with dtype-configurable moments, global-norm clipping and a cosine
schedule, port of ``repro.optim.adamw``.

Parameters, gradients and moments are keyed by parameter name (the names
of ``model.named_parameters()``, such as ``layers.3.tmix.wr``).  ``m`` and
``v`` are stored in ``state_dtype``; the update runs in f32 and is cast
back to the parameter's dtype, as in the reference.  :func:`apply` updates
the parameters and the moments in place under ``torch.no_grad()`` and
returns its metrics as 0-dim tensors, so a step needs no host sync.

On a mesh the parameters and moments are DTensors (``models/sharding.py``).
The update is elementwise, so each rank updates its own shards: the
gradient is laid out as the moment is, a ZeRO-2 weight (TP-only, its
moments FSDP-sharded) is updated on the moment's slice and gathered back
to its own layout, and the clipping norm sums every rank's shards once.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import torch_dtype
from repro_torch.models.sharding import is_dtensor
from repro_torch.models.transformer import (build_model, reference_key,
                                            stack_layers, tensor_from_numpy)


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    m: dict                     # parameter name -> first moment
    v: dict                     # parameter name -> second moment


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


# The update is elementwise, so it runs over flat slices of at most this
# many elements: the same numbers, with a leaf's f32 temporaries bounded
# (a 256,000 x 4,096 embedding would otherwise hold ~7 f32 copies of
# itself, ~29 GB, at once).
_PIECE = 1 << 26


def _pieces(t: torch.Tensor):
    """Flat views of ``t`` (contiguous) of at most ``_PIECE`` elements."""
    return t.view(-1).split(_PIECE)


def _named(params) -> dict:
    """A name -> tensor mapping from a mapping or an ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(c.warmup_steps, 1)
    t = (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = c.lr_min_ratio + (1 - c.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return c.lr_peak * torch.where(step < c.warmup_steps, warm, cos)


def init(params, c: AdamWConfig) -> AdamWState:
    """Zero moments in ``c.state_dtype`` for every parameter of ``params``
    (a name -> tensor mapping or a module)."""
    params = _named(params)
    dt = torch_dtype(c.state_dtype)
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros_like(p, dtype=dt) for n, p in params.items()},
        v={n: torch.zeros_like(p, dtype=dt) for n, p in params.items()})


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _sharded_sumsq(tree: Mapping) -> torch.Tensor:
    """The sum of squares of DTensor leaves over the whole mesh, in one
    all-reduce: each rank sums its shards, a shard held by r ranks (r the
    product of the mesh dims it is replicated on) counted 1/r of the way
    on each."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = None
    total = None
    for x in tree.values():
        mesh = x.device_mesh
        reps = 1
        for size, pl in zip(mesh.shape, x.placements):
            if isinstance(pl, Replicate):
                reps *= size
        s = torch.sum(torch.square(x.to_local().float())) / reps
        total = s if total is None else total + s
    return DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                              run_check=False) \
        .redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def global_norm(tree: Mapping) -> torch.Tensor:
    if any(is_dtensor(x) for x in tree.values()):
        return torch.sqrt(_sharded_sumsq(tree))
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Mapping, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each cast
    back to its dtype, as the reference does; the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    out = {}
    for n, g in grads.items():
        out[n] = torch.empty_like(g, memory_format=torch.contiguous_format)
        for gs, os_ in zip(_pieces(_local(g).contiguous()),
                           _pieces(_local(out[n]))):
            os_.copy_((gs.float() * scale).to(g.dtype))
    return out, norm


def reference_path(name: str) -> str:
    """The reference's pytree path of a port parameter name:
    ``layers.3.tmix.wr`` -> ``layers/tmix/wr``, ``layers.1.dense.0.mlp.wi``
    -> ``layers/dense/mlp/wi`` (layers are stacked there)."""
    return "/".join(reference_key(name)[0])


def _decay_mask(name: str) -> bool:
    """No weight decay on norms / biases / scalar gates.  Matched on the
    reference's path, since the substrings ("u", "mu", "ln", ...) are the
    reference's."""
    flat = reference_path(name)
    return not any(s in flat for s in ("scale", "ln", "bias", "b_", "mu", "u",
                                       "lam", "gate_", "w0", "kpos"))


def apply(params, grads: Mapping, state: AdamWState, c: AdamWConfig):
    """One AdamW step.  Returns (params, new_state, metrics); the
    parameters and the moments are updated in place."""
    named = _named(params)
    with torch.no_grad():
        grads = {n: g.redistribute(g.device_mesh, state.m[n].placements)
                 if is_dtensor(g) else g for n, g in grads.items()}
        grads, gnorm = clip_by_global_norm(grads, c.clip_norm)
        step = state.step + 1
        lr = lr_schedule(c, step)
        b1, b2 = c.b1, c.b2
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        sdt = torch_dtype(c.state_dtype)
        for name, p in named.items():
            decay = _decay_mask(name)
            # the moment's layout: a ZeRO-2 weight's slice of it
            target = p
            if is_dtensor(p) and p.placements != state.m[name].placements:
                target = p.redistribute(p.device_mesh,
                                        state.m[name].placements)
            loc = _local(target)
            work = loc if loc.is_contiguous() else loc.contiguous()
            for ps, m, v, g in zip(_pieces(work),
                                   _pieces(_local(state.m[name])),
                                   _pieces(_local(state.v[name])),
                                   _pieces(_local(grads[name]))):
                gf = g.float()
                mf = m.float() * b1 + gf * (1 - b1)
                vf = v.float() * b2 + gf * gf * (1 - b2)
                mhat = mf / bc1
                vhat = vf / bc2
                delta = mhat / (torch.sqrt(vhat) + c.eps)
                if decay:
                    delta = delta + c.weight_decay * ps.float()
                ps.copy_((ps.float() - lr * delta).to(ps.dtype))
                m.copy_(mf.to(sdt))
                v.copy_(vf.to(sdt))
            if work is not loc:
                loc.copy_(work)
            if target is not p:
                _local(p).copy_(_local(target.redistribute(p.device_mesh,
                                                           p.placements)))
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}


# ------------------------------------------------ the reference's layout
def opt_state_tree(state: AdamWState) -> AdamWState:
    """The state in the reference's layout: m and v as nested dicts with the
    layer leaves stacked (L, ...) under ``layers``, for a checkpoint either
    package restores."""
    return AdamWState(step=state.step, m=stack_layers(state.m),
                      v=stack_layers(state.v))


def opt_state_from_numpy(state, cfg: ModelConfig, device="cuda") \
        -> AdamWState:
    """The reference's ``AdamWState`` (numpy or tensor leaves, m and v
    stacked (L, ...) under ``layers``) as the port's, on ``device``."""
    dev = resolve_device(device)
    names = [n for n, _ in build_model(cfg, "meta").named_parameters()]

    def carry(tree):
        out = {}
        for name in names:
            key, index = reference_key(name)
            node = tree
            for part in key:
                node = node[part]
            t = tensor_from_numpy(node)
            out[name] = t[index].to(dev).clone()
        return out

    step = tensor_from_numpy(state.step).to(dev, torch.int32)
    return AdamWState(step=step, m=carry(state.m), v=carry(state.v))
