"""The work of each kernel op call, counted from its shapes, and the peaks
it is measured against.

The counts are the benchmark's own, one file an op (``bench/work/<op>.py``),
by op and not by kernel or route:
each input byte read once, each output byte written once, and the
operations that the op's arithmetic needs for these inputs (one multiply
and one add per (row, center, feature) for the distances).  A redesign, a
different route or a fusion into fewer launches leaves them unchanged.
The program's own count (``CudaKernel.flops``) is not used.
"""
from __future__ import annotations

from bench.harness.spec import load_named

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet: float32 outside the tensor
# cores and HBM3 bandwidth, at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "bytes_per_s": 3.35e12,
                              "power_limit_w": 700.0},
}
# the peaks a card of another name is measured against (and says so)
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def op_work(op: str, shapes: list, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one call of ``op`` from its operands' shapes:
    ``bench/work/<op>.py``'s ``work(shapes, itemsize)``, so a new kernel's
    count is a new file.  Raises KeyError for an op with no such file."""
    return load_named("work", op).work(shapes, itemsize)


def least_seconds(op: str, shapes: list, itemsize: int,
                  peaks: dict) -> float:
    """The least time the card could take for one call: the larger of its
    operations over the f32 peak and its bytes over the HBM peak."""
    flops, nbytes = op_work(op, shapes, itemsize)
    return max(flops / peaks["flops_f32"], nbytes / peaks["bytes_per_s"])
