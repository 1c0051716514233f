"""Node-updates (grid nodes x steps) of every render finished inside the
window, in billions, over the time from the window's start to the last of
them, on the general route."""

from portbench.harness import readers


def read(ctx):
    return readers.rate(ctx)
