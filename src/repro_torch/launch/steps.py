"""Step builders for serving, port of ``repro.launch.steps``:
``make_prefill_step`` and ``make_serve_step`` (one decode step).

The reference builds these for a mesh or for one device (``mesh=None``);
the port has no mesh yet and takes ``mesh=None`` only.  Each step runs
under ``torch.inference_mode()`` and moves its token inputs to ``device``.
The training step (forward_train, AdamW, remat) comes with a later slice
(``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (check_family, forward_decode,
                                            forward_prefill)


def _setup(cfg: ModelConfig, mesh, device) -> torch.device:
    if mesh is not None:
        raise NotImplementedError("the port runs on one device: mesh=None "
                                  "only (ROADMAP.md, queue 1)")
    check_family(cfg)
    return resolve_device(device)


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
