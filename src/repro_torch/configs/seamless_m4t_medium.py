"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596; hf].
The audio frontend is a stub: the batch supplies precomputed fbank-frame
embeddings (dim 80) under ``frames``; encoder length = seq_len // 4 (conv
downsampling)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    frontend="audio_frames", frontend_tokens=1024, frontend_dim=80,
)

SMOKE = FULL.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab=512, frontend_tokens=8,
                     frontend_dim=16, dtype="float32")
