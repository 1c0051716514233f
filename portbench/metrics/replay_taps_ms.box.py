"""Host milliseconds a render inside the program's ``mega.replay_taps`` span
(the receiver replayed over the tap block, step by step), in the traced
render."""

from portbench.harness import program_spans as spans

LAYER = ("waveguide.run: canonical, execute, the route's step or chunk loop and "
         "box_mega.replay_taps")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "box_wg_gnodes_per_s"


def read(ctx):
    return spans.ms_per(ctx, spans.seconds(ctx, "mega.replay_taps"),
                        "canonical")
