"""Tiered summary store: bounded-memory streaming for the stream tree.

Port of ``repro.store``: ``StoreSpec`` declares the policy (hot budget,
spill directory, incremental-refresh behavior); ``TieredStore`` executes
it (async spill through the checkpoint machinery, crc-verified demand
paging).  See :mod:`repro_torch.store.tiered` for the bit-identity
contract.
"""
from repro_torch.store.spec import StoreSpec
from repro_torch.store.tiered import TieredStore, summary_nbytes

__all__ = ["StoreSpec", "TieredStore", "summary_nbytes"]
