"""Device operations (kernels, copies, sets) a step in the traced render of the
shoebox route."""

from portbench.harness import readers

LAYER = ("waveguide.run: canonical, execute, the route's step or chunk loop and "
         "box_mega.replay_taps")
UNIT = "launch/step"
SOURCE = "device_trace"
MOVES = "box_wg_gnodes_per_s"


def read(ctx):
    return readers.launches_per_step(ctx)
