"""Share of the traced iterations' wall in which no device operation ran."""

from portbench.harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_iters_per_s"


def read(ctx):
    return readers.idle_pct(ctx)
