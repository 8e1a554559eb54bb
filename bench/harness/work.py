"""The work of each kernel op call, counted from its shapes, and the peaks
it is measured against.

The counts are the benchmark's own, by op and not by kernel or route:
each input byte read once, each output byte written once, and the
operations that the op's arithmetic needs for these inputs (one multiply
and one add per (row, center, feature) for the distances).  A redesign, a
different route or a fusion into fewer launches leaves them unchanged.
The program's own count (``CudaKernel.flops``) is not used.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet: float32 outside the tensor
# cores and HBM3 bandwidth, at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "bytes_per_s": 3.35e12,
                              "power_limit_w": 700.0},
}
# the peaks a card of another name is measured against (and says so)
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def op_work(op: str, shapes: list, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one call of ``op`` from its operands' shapes.

    ``min_argmin(x (n, d), c (m, d))`` -> (dist (n,) f32, idx (n,) i32):
    2 n m d operations; x and c read once, 8 n bytes written.
    ``lloyd_step(x (n, d), w (n,), c (k, d))`` -> (sums (k, d), counts
    (k,), assignment (n,) i32, dist (n,) f32): 2 n k d for the assignment
    and 2 n d for the weighted sums; x, w (f32) and c read once, the four
    outputs written once.
    """
    if op == "min_argmin":
        (n, d), (m, _) = shapes[0], shapes[1]
        return (2.0 * n * m * d,
                float(itemsize * (n * d + m * d) + 8 * n))
    if op == "lloyd_step":
        (n, d), _, (k, _) = shapes[0], shapes[1], shapes[2]
        return (2.0 * n * k * d + 2.0 * n * d,
                float(itemsize * (n * d + k * d) + 4 * n
                      + 4 * (k * d + k) + 8 * n))
    raise KeyError(f"no work count for op {op!r}")


def least_seconds(op: str, shapes: list, itemsize: int,
                  peaks: dict) -> float:
    """The least time the card could take for one call: the larger of its
    operations over the f32 peak and its bytes over the HBM peak."""
    flops, nbytes = op_work(op, shapes, itemsize)
    return max(flops / peaks["flops_f32"], nbytes / peaks["bytes_per_s"])
