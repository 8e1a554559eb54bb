"""draw_rows_per_fit: the rows the window's draws chose among (the
program's ``sampler.rows`` counter, every caller), per fit: the draws'
work count."""
from bench.harness.spans import counter_per_fit


def read(run):
    return counter_per_fit(run, "sampler.rows")
