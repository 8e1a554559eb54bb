"""device_idle: the share of the traced window in which the card ran no
operation, in percent."""
from bench.harness.readers import device_idle


def read(run):
    return device_idle(run)
