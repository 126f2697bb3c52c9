"""Fused-decode stage time over the decode steps those stages ran."""
from portbench import yardstick


def read(run):
    return yardstick.decode_step_ms(run.rec.stages, run.end)
