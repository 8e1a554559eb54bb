"""fit_s: the window over the fits it completed (host clock, first fit's
start to the last's end; the window ends after the last fit that started
within the run's seconds)."""


def read(run):
    return run.window_s / len(run.answers) if run.answers else None
