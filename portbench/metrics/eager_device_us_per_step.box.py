"""Device time a step outside B2 in the traced render: the receiver's replay
and the rest of the route's eager work."""

from portbench.harness import readers

LAYER = ("waveguide.run: canonical, execute, the route's step or chunk loop and "
         "box_mega.replay_taps")
UNIT = "us/step"
SOURCE = "device_trace"
MOVES = "box_wg_gnodes_per_s"


def read(ctx):
    return readers.other_device_us_per_step(ctx, ["b2"])
