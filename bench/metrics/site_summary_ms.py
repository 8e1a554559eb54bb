"""site_summary_ms: mean milliseconds a fit spends in its site summaries
(Algorithms 1 and 2 at every site): ``simulate_coordinator``'s
``site_summaries`` phase, or rank 0's ``site_summary`` phase of
``distributed_cluster``."""
from bench.harness.readers import phase_ms


def read(run):
    return phase_ms(run, "site_summaries", "site_summary")
