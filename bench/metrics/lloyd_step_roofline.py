"""lloyd_step_roofline: the share of the roofline that the window's
lloyd_step calls reach."""
from bench.harness.readers import roofline_share


def read(run):
    return roofline_share(run, "lloyd_step")
