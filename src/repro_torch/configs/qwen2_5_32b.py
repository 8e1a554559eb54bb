"""qwen2.5-32b — dense GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=512, dtype="float32")
