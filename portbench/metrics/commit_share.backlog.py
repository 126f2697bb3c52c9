"""After a stage's tokens reach the host: the engine's ``engine.commit``
spans inside the window (tokens appended, slots released, the profiler's
records and refits, the stage record), over the window."""
from portbench import hostspans


def read(run):
    return hostspans.share(run.end, hostspans.COMMIT)
