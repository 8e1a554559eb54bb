"""min_argmin_roofline: the share of the roofline that the window's
min_argmin calls reach."""
from bench.harness.readers import roofline_share


def read(run):
    return roofline_share(run, "min_argmin")
