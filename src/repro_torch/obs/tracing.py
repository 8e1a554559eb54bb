"""The flight recorder's config-artifact knobs: ``TraceSpec``.

Port of ``repro.obs.tracing``'s ``TraceSpec`` (and the ring size it
defaults to) only, so that ``PipelineConfig``'s optional ``tracing``
section reads and validates as the reference's does.  The recorder the
spec configures (spans, sampling, Chrome trace export) is not ported yet
(ROADMAP.md, queue 4): ``Session`` refuses a config whose ``tracing`` is
set rather than let the section be silently inert.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

_DEFAULT_RING = 65536


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Config-artifact knobs for the flight recorder (``tracing:``)."""

    enabled: bool = True
    sample_rate: float = 1.0
    ring: int = _DEFAULT_RING
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= float(self.sample_rate) <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {self.sample_rate}")
        if int(self.ring) < 1:
            raise ValueError(f"ring must be >= 1, got {self.ring}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": bool(self.enabled),
            "sample_rate": float(self.sample_rate),
            "ring": int(self.ring),
            "seed": int(self.seed),
        }
