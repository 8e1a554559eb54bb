"""Model side of the port: the configuration, the shared layers
(attention, RoPE, the MLPs), token-choice MoE, the RWKV6 block, the RG-LRU
block (``rglru``) and all five families' training, prefill and decode
(``transformer``: dense, moe, rwkv6, rglru_hybrid, encdec)."""
