"""Kernel 1 (paged decode attention): the sum of its calls' bounds in the
traced steps, each from the call's slot lengths (yardstick.kernel_calls),
over its device time in the trace."""
from portbench import bench


def read(run):
    tr = run.rec.trace
    if tr is None:
        return None
    _, secs = tr.seconds_matching(bench.K1)
    if secs <= 0:
        return None
    bound_ms = run.kernel_bounds()
    return 100 * bound_ms / 1e3 / secs if bound_ms > 0 else None
