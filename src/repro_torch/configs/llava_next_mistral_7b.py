"""llava-next-mistral-7b — Mistral backbone, anyres tiling stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Frontend is a stub:
input_specs() supplies 2880 precomputed patch embeddings (5 x 576 anyres
tiles, SigLIP/CLIP-dim 1152) projected + prepended to the text tokens."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    frontend="vlm_patches", frontend_tokens=2880, frontend_dim=1152,
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=512, frontend_tokens=8, frontend_dim=16,
                     dtype="float32")
