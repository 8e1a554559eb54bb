"""Declarative knobs for the tiered summary store.

Port of ``repro.store.spec`` (no change but this paragraph).  A
:class:`StoreSpec` travels on ``TreeConfig`` / ``BaseServiceConfig`` (all
frozen, JSON-scalar fields) and controls two orthogonal behaviors:

* **tiering** (``hot_levels`` / ``hot_bytes``): which merge-and-reduce
  levels stay resident in memory and which spill to the disk tier.  Unset
  both and nothing ever spills — the tree is exactly the in-memory one.
* **incremental refresh** (``incremental_refresh`` /
  ``warm_start_frac``): whether a serving refresh may skip the
  second-level k-means-- when the tree root has not changed since the
  last fit, and warm-start from the previous centers when little has.

Either way the tree root — and therefore every score — is bit-identical
to the untiered, always-refit configuration; the spec only moves bytes
and skips provably-redundant work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Hot-budget + refresh-reuse policy for the stream tree.

    hot_levels: tree levels ``<= hot_levels`` stay resident; deeper
        (older, colder) summaries spill to disk.  ``None`` = no level rule.
    hot_bytes: resident summary payload budget in bytes; when exceeded the
        deepest-then-oldest resident summaries spill until under budget.
        ``None`` = no byte rule.  The leaf buffer is always resident.
    directory: spill root on disk.  ``None`` = a fresh temp directory per
        tree, removed when the tree is garbage-collected.
    incremental_refresh: skip the second-level fit entirely when no root
        changed since the last fit (the model would be bit-identical).
    warm_start_frac: when ``0 < changed mass fraction <= warm_start_frac``
        since the last fit, seed the second-level k-means-- from the
        previous centers instead of re-seeding.  0 (default) never
        warm-starts — warm starts trade bit-identity to always-refit for
        faster convergence, so they are strictly opt-in.
    """

    hot_levels: Optional[int] = None
    hot_bytes: Optional[int] = None
    directory: Optional[str] = None
    incremental_refresh: bool = True
    warm_start_frac: float = 0.0

    def __post_init__(self):
        if self.hot_levels is not None and (
                not isinstance(self.hot_levels, int)
                or isinstance(self.hot_levels, bool) or self.hot_levels < 0):
            raise ValueError(f"store.hot_levels must be an int >= 0 or None, "
                             f"got {self.hot_levels!r}")
        if self.hot_bytes is not None and (
                not isinstance(self.hot_bytes, int)
                or isinstance(self.hot_bytes, bool) or self.hot_bytes < 1):
            raise ValueError(f"store.hot_bytes must be an int >= 1 or None, "
                             f"got {self.hot_bytes!r}")
        if self.directory is not None and not isinstance(self.directory, str):
            raise ValueError(f"store.directory must be a string path or "
                             f"None, got {self.directory!r}")
        if not isinstance(self.incremental_refresh, bool):
            raise ValueError(f"store.incremental_refresh must be a bool, "
                             f"got {self.incremental_refresh!r}")
        wf = self.warm_start_frac
        if isinstance(wf, bool) or not isinstance(wf, (int, float)) \
                or not 0.0 <= float(wf) <= 1.0:
            raise ValueError(f"store.warm_start_frac must be a float in "
                             f"[0, 1], got {wf!r}")
        object.__setattr__(self, "warm_start_frac", float(wf))

    @property
    def tiered(self) -> bool:
        """True iff some hot budget is set, i.e. summaries may spill."""
        return self.hot_levels is not None or self.hot_bytes is not None
