"""B6's and B7's share of their roofline in the traced iterations: their
launches' bound over their device time."""

from portbench.harness import readers

LAYER = "kernels (csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_iters_per_s"


def read(ctx):
    return readers.roofline_pct(ctx, ["b6", "b7"])
