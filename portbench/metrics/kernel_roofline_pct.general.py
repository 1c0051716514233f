"""B8's share of its roofline in the traced render: its launches' bound over
their device time."""

from portbench.harness import readers

LAYER = "kernels (csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "general_wg_gnodes_per_s"


def read(ctx):
    return readers.roofline_pct(ctx, ["b8"])
