"""Seconds the program spent loading its kernel libraries, builds included
(its ``kernels.load:<library>`` spans, each holding any
``kernels.build:<library>``), since the process started; read in the traced
run.  None without the slice or without a library span."""

LAYER = "kernels (csrc)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    if not ctx.get("slice"):
        return None
    from wayverb_tpu_torch.utils import events
    totals = getattr(events, "totals", None)
    if totals is None:
        return None
    loads = [t for name, (t, _) in totals().items()
             if name.startswith("kernels.load:")]
    return sum(loads) if loads else None
