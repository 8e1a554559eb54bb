"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]. SWA makes it sub-quadratic -> long_500k runs."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, sliding_window=4096, rope_theta=10000.0,
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=512, sliding_window=16, dtype="float32")
