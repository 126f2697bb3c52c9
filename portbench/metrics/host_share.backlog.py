"""1 - the program's stage time (its stage records) inside the window over
the window: host work between stages, the harness's share of it included."""
from portbench import yardstick


def read(run):
    if not run.rec.steps:
        return None
    return 100 * yardstick.host_share(run.rec.stages, run.end)
