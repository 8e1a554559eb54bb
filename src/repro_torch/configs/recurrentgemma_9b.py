"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified]. Sub-quadratic: its decode state stays O(1)
past the local window."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="rglru_hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    rec_per_attn=2, local_window=2048, lru_width=4096,
)

SMOKE = FULL.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=1,
                     head_dim=16, d_ff=128, vocab=512, rec_per_attn=2,
                     local_window=16, lru_width=64, dtype="float32")
