"""rwkv6-7b — Finch, attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536, rwkv_head_dim=64,
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                     head_dim=32, rwkv_head_dim=32, d_ff=128, vocab=512,
                     dtype="float32")
