"""Telemetry specs.  Port of ``repro.obs``'s ``TraceSpec`` only: the
metrics registry, the flight recorder and the monitors are not ported yet
(ROADMAP.md, queue 4)."""
from repro_torch.obs.tracing import TraceSpec

__all__ = ["TraceSpec"]
