"""Optimizer, port of ``repro.optim``: AdamW (``adamw``) and gradient
compression with error feedback (``compression``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, AdamWState, apply, clip_by_global_norm, global_norm, init,
    lr_schedule, opt_state_from_numpy, opt_state_tree,
)
from repro_torch.optim.compression import (  # noqa: F401
    EFState, decode_bf16, decode_int8, encode_bf16, encode_int8, init_ef,
)
