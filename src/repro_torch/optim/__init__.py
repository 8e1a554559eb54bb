"""Optimizer, port of ``repro.optim``: AdamW (``adamw``).  Gradient
compression (``repro.optim.compression``) is not ported yet
(``ROADMAP.md``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, AdamWState, apply, clip_by_global_norm, global_norm, init,
    lr_schedule, opt_state_from_numpy, opt_state_tree,
)
