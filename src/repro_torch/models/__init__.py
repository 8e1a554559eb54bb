"""Model side of the port: the configuration, the shared layers
(attention, RoPE, the MLPs), token-choice MoE, the RWKV6 block and the
dense, moe and rwkv6 families' training, prefill and decode
(``ROADMAP.md`` lists the families still to port)."""
