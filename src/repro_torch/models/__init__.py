"""Model side of the port: the configuration, the layers RWKV6 uses, the
RWKV6 block and the rwkv6 family's prefill and decode (``ROADMAP.md`` lists
the families still to port)."""
