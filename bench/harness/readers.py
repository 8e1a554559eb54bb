"""What the per-layer metric readers (``bench/metrics/<name>.py``) share:
each reader names its quantity and calls one of these, so a metric split
by the end-to-end metric it moves reads the same thing in each cell."""
from __future__ import annotations

from bench.harness.work import least_seconds


def phase_ms(run, *phases):
    """Mean milliseconds a fit spends in the first of ``phases`` that its
    ``phase_s`` has (the program's own span, ended by a device sync)."""
    vals = []
    for a in run.answers:
        got = [a.get("phase_s", {}).get(p) for p in phases]
        got = [v for v in got if v is not None]
        if got:
            vals.append(got[0])
    return 1e3 * sum(vals) / len(vals) if vals else None


def launches_per_fit(run):
    """Calls of the port's CUDA kernel ops over the traced window (each
    bumps its ``CudaKernel.launches`` once and is handed to
    ``CudaKernel.observers``), per fit, on rank 0."""
    if not run.answers or not run.trace.calls:
        return None
    return len(run.trace.calls) / len(run.answers)


def roofline_share(run, op: str):
    """The share of the roofline that ``op``'s calls reach: for every call
    the trace tied to device kernels, the least time the card could take
    for it (``work.least_seconds``: the benchmark's own count of its
    operations and bytes against the card's published peaks) summed, over
    the device time of the kernels those calls launched, in percent."""
    calls = [c for c in run.trace.calls
             if c.op == op and c.kernels and c.device_s > 0]
    if not calls:
        return None
    least = sum(least_seconds(op, c.shapes, c.itemsize, run.peaks)
                for c in calls)
    return 100.0 * least / sum(c.device_s for c in calls)


def device_idle(run):
    """The share of rank 0's traced window in which the card ran no
    operation (kernel, copy or set), in percent."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
