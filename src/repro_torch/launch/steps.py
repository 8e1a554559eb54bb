"""Step builders, port of ``repro.launch.steps``: ``make_train_step``
(forward, backward, AdamW), ``make_prefill_step`` and ``make_serve_step``
(one decode step).

These are the programs the dry run counts and the launchers run; the same
builders serve one device (``mesh=None``).  With a ``DeviceMesh`` the model
must be laid out first (``models.sharding.shard_model_``, and
``shard_opt_state_`` for the moments); each step lays out its whole batch
(and a whole cache) by ``batch_specs`` / ``cache_specs``, each rank taking
its own slice with no communication, runs under DTensor's
``implicit_replication`` (a plain tensor, a position vector or a zero
state, counts as the same on every rank), and returns DTensors.  Each step
moves its batch (``tokens``, and a frontend's ``patches`` or ``frames``:
an encdec batch's frames reach its encoder) to ``device``; the serving
steps run under ``torch.inference_mode()``, on a mesh under
``torch.no_grad()`` (DTensor's redistribution of a parameter fails under
inference mode in some torch releases).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx, is_dtensor
from repro_torch.models.sharding import batch_specs, cache_specs, fsdp_axes
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            forward_train, model_class)
from repro_torch.optim import adamw


def make_ctx(cfg: ModelConfig, mesh) -> ShardCtx:
    if mesh is None:
        return ShardCtx(mesh=None)
    if "model" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise TypeError(f"mesh must be a DeviceMesh with a 'model' axis "
                        f"(launch/mesh.py), not {mesh!r}")
    return ShardCtx(mesh=mesh, batch=fsdp_axes(mesh), model="model",
                    seq_shard=cfg.seq_shard_activations)


def _setup(cfg: ModelConfig, device) -> torch.device:
    model_class(cfg)
    return resolve_device(device)


def _scope(ctx: ShardCtx):
    if ctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _serving(ctx: ShardCtx):
    return torch.inference_mode() if ctx.mesh is None else torch.no_grad()


def _lay_out(tree: dict, specs: dict, ctx: ShardCtx) -> dict:
    """Whole tensors (the same on every rank) as DTensors laid out by
    ``specs``; a tensor of rank <= 1 (``kpos``, ``pos``) stays plain."""
    if ctx.mesh is None:
        return tree
    return {k: t if is_dtensor(t) or t.dim() <= 1 else
            ctx.hint(ctx.replicated(t), *specs[k]) for k, t in tree.items()}


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(cfg: ModelConfig, mesh=None,
                    optc: adamw.AdamWConfig | None = None, *, device="cuda"):
    """Returns (train_step, optc).  ``train_step(model, opt_state, batch)``
    runs ``forward_train``, its backward pass and ``adamw.apply`` (which
    updates the model and the moments in place) and returns (model,
    opt_state, metrics): the reference's keys, as 0-dim tensors."""
    dev = _setup(cfg, device)
    optc = optc or adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    ctx = make_ctx(cfg, mesh)

    def train_step(model, opt_state: adamw.AdamWState, batch: dict):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with _scope(ctx):
            if mesh is not None:
                batch = _lay_out(batch, batch_specs(batch, mesh), ctx)
            params = dict(model.named_parameters())
            loss, metrics = forward_train(model, batch, cfg, ctx)
            grads = torch.autograd.grad(loss, list(params.values()))
            _, opt_state, om = adamw.apply(params, dict(zip(params, grads)),
                                           opt_state, optc)
        metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
        return model, opt_state, dict(metrics, loss=_whole(loss.detach()),
                                      **om)

    return train_step, optc


def make_prefill_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    dev = _setup(cfg, device)
    ctx = make_ctx(cfg, mesh)

    def prefill_step(params, batch: dict, max_len: int | None = None):
        with _serving(ctx), _scope(ctx):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            if mesh is not None:
                batch = _lay_out(batch, batch_specs(batch, mesh), ctx)
            return forward_prefill(params, batch, cfg, max_len, ctx)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    dev = _setup(cfg, device)
    ctx = make_ctx(cfg, mesh)

    def serve_step(params, cache: dict, tokens):
        with _serving(ctx), _scope(ctx):
            tokens = torch.as_tensor(tokens, device=dev)
            if mesh is not None:
                cache = _lay_out(cache, cache_specs(cache, mesh, cfg), ctx)
                tokens = _lay_out({"tokens": tokens},
                                  batch_specs({"tokens": tokens}, mesh),
                                  ctx)["tokens"]
            return forward_decode(params, cache, tokens, cfg, ctx)

    return serve_step
