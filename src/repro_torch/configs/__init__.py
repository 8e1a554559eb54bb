"""Architecture registry, port of ``repro.configs``.

``get_config(arch_id, smoke=False)`` returns the exact assigned config
(FULL) or the reduced same-family config the CPU tests use (SMOKE).  The
port serves rwkv6-7b so far; every other architecture of the reference's
registry raises ``NotImplementedError`` until its family is ported
(``ROADMAP.md``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {"rwkv6-7b": "rwkv6_7b"}

# the reference's registry, so a known architecture that is not ported yet
# is told apart from a name that does not exist
ARCH_IDS = [
    "rwkv6-7b", "llava-next-mistral-7b", "qwen2.5-32b", "qwen2-72b",
    "granite-20b", "h2o-danube-1.8b", "seamless-m4t-medium",
    "llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
]

# The reference's per-arch beyond-baseline settings: cfg overrides plus a
# logical (data, model) re-mesh of a TPU pod.  The port runs on one card and
# has no mesh, so only the overrides apply to it.
OPTIMIZED = {
    "rwkv6-7b": ({"wkv_inner_remat": True, "wkv_chunk": 64}, (128, 2)),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port serves "
            f"{sorted(_MODULES)} (ROADMAP.md, queue 1)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
