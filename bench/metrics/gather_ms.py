"""gather_ms: mean milliseconds of a fit's one exchange of the site
summaries (``gather_sites``), rank 0's ``gather`` phase of
``distributed_cluster``, waiting for the other sites included."""
from bench.harness.readers import phase_ms


def read(run):
    return phase_ms(run, "gather")
