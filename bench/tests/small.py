"""Small versions of the benchmark's cells, for the CPU tests."""
import dataclasses

from bench.harness.spec import load_cell

SMALL = {
    "kdd_like": dict(n=20_000, t=180),
    "susy_like": dict(n=20_000, t=100, k=10,
                      dataset_args={"t": 100, "delta": 5.0}),
}


def small_cell(workload: str, **over):
    """The cell with its configuration cut to a CPU test's size (20,000
    rows, the planted outliers' t) and the traffic's checks kept."""
    cell = load_cell(workload)
    cfg = dict(cell.config)
    cfg.update(SMALL[cfg["dataset"]])
    cfg.update(over)
    return dataclasses.replace(cell, config=cfg)

# Limits for the small cells: a row in 20,000 is 5e-5 of moved_share, so
# one near tie could cross a full-size limit; the faults read 1e-2 and up.
SMALL_LIMITS = {"broken": 0, "moved_share": 1e-3, "cost_gap": 1e-5,
                "center_step": 0.1}
