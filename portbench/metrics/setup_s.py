"""Set-up: process start to the window's start (imports, the weights drawn
on the device, the engine built, every dispatch of the cell captured, and in
a checkout's first run the kernels' build). Host clock."""


def read(run):
    return run.setup_s
