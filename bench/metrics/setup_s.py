"""setup_s: host seconds from the process's start to the window: imports,
the rows made on the card, the fit's kernels built where missing and
loaded, the warm fits; on several cards, the ranks started and met."""


def read(run):
    return run.setup_s
