"""Model configuration shared by every assigned architecture.

Port of ``repro.models.config``: the same dataclass, field for field, so a
configuration reads the same in both packages.  One dataclass covers the
five families (dense / moe / rwkv6 / rglru_hybrid / encdec), all of which
the port serves.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv6 | rglru_hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"       # swiglu | gelu (gpt-bigcode style)
    sliding_window: int = 0        # 0 = full attention; >0 = SWA width
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert FFN width
    moe_every: int = 1             # MoE layer every N layers (others dense d_ff)
    shared_expert_d_ff: int = 0    # 0 = no shared expert
    capacity_factor: float = 1.25
    moe_group_tokens: int = 4096   # dispatch-group granularity (see moe.py)

    # enc-dec
    n_enc_layers: int = 0

    # hybrid (recurrentgemma): `pattern` repeats [R]*rec_per_attn + [A]
    rec_per_attn: int = 0
    local_window: int = 0
    lru_width: int = 0             # 0 -> d_model

    # rwkv6
    rwkv_head_dim: int = 64
    wkv_chunk: int = 16            # intra-chunk length of the chunked WKV scan
    wkv_compute_dtype: str = "float32"  # bf16: halve intra-chunk HBM traffic
    #   (decay cumsums + carried state stay f32 regardless)
    wkv_use_pallas: bool = False   # route WKV through the Pallas chunk kernel

    # modality frontend (stub: input_specs provides precomputed embeddings)
    frontend: str = "none"         # none | vlm_patches | audio_frames
    frontend_tokens: int = 0       # patches / frames prepended to text
    frontend_dim: int = 0          # raw patch/frame feature dim (stub proj in)

    # numerics & distribution knobs (perf levers — see EXPERIMENTS §Perf)
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat_policy: str = "nothing"  # nothing | dots | none(=no remat)
    seq_shard_activations: bool = True
    attn_q_chunk: int = 1024       # query-chunked attention block
    attn_chunk_remat: bool = False # re-materialize scores per q-chunk in bwd
    wkv_inner_remat: bool = False  # recompute WKV chunk internals in bwd
    zero_stage: int = 3            # 3 = params+moments FSDP; 2 = moments only

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        return self.family in ("rwkv6", "rglru_hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder (none are encoder-only)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = D * hd * Hq + 2 * D * hd * Hkv + hd * Hq * D
        if self.qkv_bias:
            attn += hd * (Hq + 2 * Hkv)
        dense_ffn = (3 if self.mlp_type == "swiglu" else 2) * D * F
        norms = 2 * D

        if self.family == "rwkv6":
            hdim = self.rwkv_head_dim
            H = D // hdim
            tmix = 5 * D * D           # r,k,v,g,out projections (decay is LoRA-only)
            tmix += 2 * 64 * D         # decay LoRA (rank 64)
            tmix += 5 * D + H * hdim   # token-shift mus + bonus u
            cmix = D * F + F * D + D * D  # channel mix: key, value, receptance
            per_layer = tmix + cmix + norms
            body = self.n_layers * per_layer
        elif self.family == "rglru_hybrid":
            W = self.lru_width or D
            rec = 2 * D * W + W * D + 6 * W  # in/out projections + LRU gates/Lambda
            conv = 4 * W                     # depthwise temporal conv (width 4)
            rec_block = rec + conv + dense_ffn + norms
            attn_block = attn + dense_ffn + norms
            n_attn = self.n_layers // (self.rec_per_attn + 1)
            body = n_attn * attn_block + (self.n_layers - n_attn) * rec_block
        elif self.family == "moe":
            Fe = self.moe_d_ff
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            experts = self.n_experts * 3 * D * Fe
            shared = 3 * D * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
            router = D * self.n_experts
            body = (self.n_layers * (attn + norms)
                    + n_moe * (experts + shared + router)
                    + n_dense * dense_ffn)
        elif self.family == "encdec":
            enc_layer = attn + dense_ffn + norms
            dec_layer = attn + attn + dense_ffn + 3 * D  # self + cross
            body = self.n_enc_layers * enc_layer + self.n_layers * dec_layer
        else:
            body = self.n_layers * (attn + dense_ffn + norms)

        embed = V * D
        head = 0 if self.tie_embeddings else V * D
        total = body + embed + head + D

        if active_only and self.family == "moe":
            Fe = self.moe_d_ff
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            active_experts = self.top_k * 3 * D * Fe
            shared = 3 * D * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
            total = (self.n_layers * (attn + norms)
                     + n_moe * (active_experts + shared + D * self.n_experts)
                     + n_dense * dense_ffn
                     + embed + head + D)
        return int(total)
