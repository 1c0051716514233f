"""Milliseconds an iteration in which the device ran nothing while the host
was inside ``mega.theta_grads``, in the traced iterations."""

from portbench.harness import program_spans as spans

LAYER = ("waveguide.box_mega autograd: mega_canonical_loss_fn, _MegaRun, "
         "_chunk_theta_grads")
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fit_iters_per_s"


def read(ctx):
    return spans.ms_per(ctx, spans.idle_seconds(ctx, "mega.theta_grads"),
                        "mega.backward")
