"""pairs_per_fit: the (row, center) pairs the window's min_argmin and
lloyd_step calls asked for (the program's ``kernels.pairs`` counter, every
op and route), per fit: the distance work's count, as draw_rows_per_fit is
the draws'."""
from bench.harness.spans import counter_per_fit


def read(run):
    return counter_per_fit(run, "kernels.pairs")
