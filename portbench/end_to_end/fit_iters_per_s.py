"""Value-and-gradient iterations finished inside the window over the time
from the window's start to the last of them."""

from portbench.harness import readers


def read(ctx):
    return readers.rate(ctx)
