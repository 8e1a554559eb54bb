"""second_level_ms: mean milliseconds a fit spends in its second level
(weighted k-means++ seeding and k-means-- at the coordinator)."""
from bench.harness.readers import phase_ms


def read(run):
    return phase_ms(run, "second_level")
