"""Device time a step outside B8 in the traced render: the eager boundary pass,
the stability test, the injection and the taps."""

from portbench.harness import readers

LAYER = ("waveguide.run: canonical, execute, the route's step or chunk loop and "
         "box_mega.replay_taps")
UNIT = "us/step"
SOURCE = "device_trace"
MOVES = "general_wg_gnodes_per_s"


def read(ctx):
    return readers.other_device_us_per_step(ctx, ["b8"])
