"""llama4-maverick-400b-a17b — MoE 128e top-1 + shared expert, early-fusion
image stub [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

16 GB/chip HBM at 256 chips requires bf16 optimizer moments (DESIGN §6);
recorded as part of the §Perf memory-term iteration."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16384, vocab=202048,
    # assignment's d_ff=8192 is the EXPERT width (moe_d_ff); Maverick
    # interleaves MoE every other layer with dense d_ff=16384 between —
    # this is what lands the advertised 400B total / 17B active.
    n_experts=128, top_k=1, moe_d_ff=8192, moe_every=2, shared_expert_d_ff=8192,
    frontend="vlm_patches", frontend_tokens=1024, frontend_dim=1152,
    opt_state_dtype="bfloat16",
)

SMOKE = FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=512, n_experts=8, top_k=1, moe_d_ff=64,
                     moe_every=2, shared_expert_d_ff=64, frontend_tokens=8, frontend_dim=16,
                     moe_group_tokens=32, dtype="float32",
                     opt_state_dtype="float32")
