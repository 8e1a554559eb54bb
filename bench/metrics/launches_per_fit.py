"""launches_per_fit: calls of the port's CUDA kernel ops per fit."""
from bench.harness.readers import launches_per_fit


def read(run):
    return launches_per_fit(run)
