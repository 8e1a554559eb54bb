"""records_per_fit: records the sites sent to the coordinator, over all
fits of the window, per fit; counted by the harness from each answer's
valid ids."""
from bench.harness.program import records


def read(run):
    if not run.answers:
        return None
    return sum(records(a) for a in run.answers) / len(run.answers)
