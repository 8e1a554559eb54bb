"""Architecture registry, port of ``repro.configs``.

``get_config(arch_id, smoke=False)`` returns the exact assigned config
(FULL) or the reduced same-family config the CPU tests use (SMOKE), for
every architecture of the reference's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-72b": "qwen2_72b",
    "granite-20b": "granite_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = list(_MODULES)

# The reference's per-arch beyond-baseline settings: cfg overrides plus a
# logical (data, model) re-mesh of the production pod's ranks, both applied
# by the dry run (``launch/dryrun.py --optimized``); one card takes the
# overrides only.
OPTIMIZED = {
    "qwen2-72b": ({"attn_chunk_remat": True}, (128, 2)),
    "rwkv6-7b": ({"wkv_inner_remat": True, "wkv_chunk": 64}, (128, 2)),
    "qwen3-moe-235b-a22b": ({"attn_chunk_remat": True,
                             "moe_group_tokens": 512}, (128, 2)),
    "qwen2.5-32b": ({"attn_chunk_remat": True}, (128, 2)),
    "granite-20b": ({"attn_chunk_remat": True}, (128, 2)),
    "llava-next-mistral-7b": ({"attn_chunk_remat": True}, (128, 2)),
    "h2o-danube-1.8b": ({"attn_chunk_remat": True}, (128, 2)),
    "seamless-m4t-medium": ({"attn_chunk_remat": True}, (128, 2)),
    "llama4-maverick-400b-a17b": ({"attn_chunk_remat": True}, (64, 4)),
    "recurrentgemma-9b": ({"attn_chunk_remat": True}, (128, 2)),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
