"""Mean milliseconds of the forward (mega_canonical_loss_fn and the loss),
ended by a synchronize, over the traced run's window."""

from portbench.harness import readers

LAYER = ("waveguide.box_mega autograd: mega_canonical_loss_fn, _MegaRun, "
         "_chunk_theta_grads")
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fit_iters_per_s"


def read(ctx):
    return readers.mean_ms(ctx["fit"]["fwd_s"]) if ctx.get("fit") else None
