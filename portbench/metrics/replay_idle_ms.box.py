"""Milliseconds a render in which the device ran nothing while the host was
inside ``mega.replay_taps``, in the traced render."""

from portbench.harness import program_spans as spans

LAYER = ("waveguide.run: canonical, execute, the route's step or chunk loop and "
         "box_mega.replay_taps")
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "box_wg_gnodes_per_s"


def read(ctx):
    return spans.ms_per(ctx, spans.idle_seconds(ctx, "mega.replay_taps"),
                        "canonical")
