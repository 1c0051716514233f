"""Share of the traced render's wall in which no device operation ran."""

from portbench.harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "box_wg_gnodes_per_s"


def read(ctx):
    return readers.idle_pct(ctx)
