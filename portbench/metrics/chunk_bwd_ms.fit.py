"""Host milliseconds an iteration inside the program's ``mega.chunk_bwd``
spans (each ``mega_chunk_bwd`` call, B7 enqueued), in the traced
iterations."""

from portbench.harness import program_spans as spans

LAYER = ("waveguide.box_mega autograd: mega_canonical_loss_fn, _MegaRun, "
         "_chunk_theta_grads")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fit_iters_per_s"


def read(ctx):
    return spans.ms_per(ctx, spans.seconds(ctx, "mega.chunk_bwd"),
                        "mega.backward")
