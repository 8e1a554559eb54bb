"""Step builders, port of ``repro.launch.steps``: ``make_train_step``
(forward, backward, AdamW), ``make_prefill_step`` and ``make_serve_step``
(one decode step).

The reference builds these for a mesh or for one device (``mesh=None``);
the port has no mesh yet and takes ``mesh=None`` only.  Each step moves its
batch (``tokens``, and a frontend's ``patches`` or ``frames``: an encdec
batch's frames reach its encoder) to ``device``; the serving steps run
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            forward_train, model_class)
from repro_torch.optim import adamw


def _setup(cfg: ModelConfig, mesh, device) -> torch.device:
    if mesh is not None:
        raise NotImplementedError("the port runs on one device: mesh=None "
                                  "only (ROADMAP.md, queue 1)")
    model_class(cfg)
    return resolve_device(device)


def make_train_step(cfg: ModelConfig, mesh=None,
                    optc: adamw.AdamWConfig | None = None, *, device="cuda"):
    """Returns (train_step, optc).  ``train_step(model, opt_state, batch)``
    runs ``forward_train``, its backward pass and ``adamw.apply`` (which
    updates the model and the moments in place) and returns (model,
    opt_state, metrics): the reference's keys, as 0-dim tensors."""
    dev = _setup(cfg, mesh, device)
    optc = optc or adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)

    def train_step(model, opt_state: adamw.AdamWState, batch: dict):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = dict(model.named_parameters())
        loss, metrics = forward_train(model, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, om = adamw.apply(params, dict(zip(params, grads)),
                                       opt_state, optc)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return model, opt_state, dict(metrics, loss=loss.detach(), **om)

    return train_step, optc


def make_prefill_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    dev = _setup(cfg, mesh, device)

    def prefill_step(params, batch: dict, max_len: int | None = None):
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            return forward_prefill(params, batch, cfg, max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    dev = _setup(cfg, mesh, device)

    def serve_step(params, cache: dict, tokens):
        with torch.inference_mode():
            return forward_decode(params, cache,
                                  torch.as_tensor(tokens, device=dev), cfg)

    return serve_step
