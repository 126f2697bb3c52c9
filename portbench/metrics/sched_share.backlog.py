"""The engine's scheduling on the host: its ``engine.schedule``,
``engine.policy`` and ``engine.plan`` spans inside the window (the batch
proposed, the Lagrangian's decision, chunk and page planning), over the
window."""
from portbench import hostspans


def read(run):
    return hostspans.share(run.end, hostspans.SCHED)
