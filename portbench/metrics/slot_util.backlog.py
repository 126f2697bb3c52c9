"""The paper's utilization on the wall clock: busy slot-seconds of the
program's stage records over slots x window."""
from portbench import yardstick


def read(run):
    if not run.rec.steps:
        return None
    return 100 * yardstick.slot_util(run.rec.stages, run.cell.engine["n_slots"], run.end)
