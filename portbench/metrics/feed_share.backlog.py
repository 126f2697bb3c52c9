"""Feeding the device: the engine's ``engine.load`` and ``engine.sync``
spans inside the window (a dispatch's host inputs built and copied in, the
synchronise before its replay), over the window."""
from portbench import hostspans


def read(run):
    return hostspans.share(run.end, hostspans.FEED)
