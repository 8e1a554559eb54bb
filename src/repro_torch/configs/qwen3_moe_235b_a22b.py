"""qwen3-moe-235b-a22b — 128 experts top-8, head_dim=128 (64x128 != d_model)
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, moe_d_ff=1536,
    opt_state_dtype="bfloat16",
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=64, vocab=512, n_experts=8, top_k=2,
                     moe_d_ff=64, moe_group_tokens=32, dtype="float32",
                     opt_state_dtype="float32")
