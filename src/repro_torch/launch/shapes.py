"""Assigned input shapes and their meta-tensor builders for the dry run,
port of ``repro.launch.shapes``.

Four shapes per LM arch (40 cells):
  train_4k     seq 4096,   batch 256  -> train_step
  prefill_32k  seq 32768,  batch 32   -> prefill_step
  decode_32k   seq 32768,  batch 128  -> serve_step (1 token, cache = seq)
  long_500k    seq 524288, batch 1    -> serve_step; SUB-QUADRATIC archs only
               (rwkv6 / rglru hybrid / SWA); full-attention archs record the
               skip.

The reference's ``ShapeDtypeStruct``s are tensors on the ``meta`` device
here (a shape and a dtype, no data).  ``[audio]`` / ``[vlm]`` frontends are
stubs: the batch carries precomputed frame / patch embeddings; encoder
frames = seq_len // 4 (conv downsampling).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full attention is O(S^2): long_500k runs only for "
                       "SSM/hybrid/SWA archs")
    return True, ""


def input_structs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors of the model-input batch of a train / prefill cell."""
    B, L = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _meta((B, max(L // 4, 8), cfg.frontend_dim),
                                torch.float32),
                "tokens": _meta((B, L), torch.int32)}
    if cfg.frontend == "vlm_patches":
        s_text = L - cfg.frontend_tokens
        if s_text <= 0:
            raise ValueError(f"{cfg.name}: {cfg.frontend_tokens} patches "
                             f"leave no text in {L} positions")
        return {"patches": _meta((B, cfg.frontend_tokens, cfg.frontend_dim),
                                 torch.float32),
                "tokens": _meta((B, s_text), torch.int32)}
    return {"tokens": _meta((B, L), torch.int32)}


def decode_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """The config a decode cell's cache is built with: an encdec cache holds
    seq_len // 4 encoder frames."""
    if cfg.family == "encdec":
        return cfg.replace(frontend_tokens=max(shape.seq_len // 4, 8))
    return cfg


def decode_structs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(cache meta tensors, token meta tensor) for a decode cell: one new
    token with a cache that has already absorbed seq_len tokens."""
    from repro_torch.models.transformer import init_cache
    B, L = shape.global_batch, shape.seq_len
    cache = init_cache(decode_config(cfg, shape), B, L, device="meta")
    return cache, _meta((B, 1), torch.int32)


def concrete_batch(cfg: ModelConfig, seq_len: int, batch: int,
                   generator: torch.Generator) -> dict:
    """A concrete small batch for smoke tests and examples (the layout of
    :func:`input_structs`), drawn from ``generator`` on its device."""
    structs = input_structs(cfg, ShapeSpec("adhoc", seq_len, batch, "train"))
    dev = generator.device
    out = {}
    for k, st in structs.items():
        if st.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, st.shape, generator=generator,
                                   dtype=torch.int32, device=dev)
        else:
            out[k] = torch.randn(st.shape, generator=generator,
                                 dtype=st.dtype, device=dev)
    return out
