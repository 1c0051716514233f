"""What the readers of the program's own spans share.

The program marks its stages with ``record_function("wayverb.<name>")``
while a profiler records (``wayverb_tpu_torch.utils.events.span``).  The
traced slice keeps them among its host events (``slice["host"]``: start,
end, name, on the device operations' clock), so each reader here takes the
seconds inside the spans of one name, how many spans of a root name the
slice holds (renders, iterations), and the device's idle time inside a
span's intervals.  A reader that finds no such span returns None: a
program without the span, or a run without the slice.
"""

from __future__ import annotations

from portbench.harness import timing

PREFIX = "wayverb."


def intervals(ctx, name: str):
    """(start, end) of every ``wayverb.<name>`` span in the traced slice,
    on any thread."""
    sl = ctx.get("slice")
    if not sl:
        return []
    full = PREFIX + name
    return [(s, e) for s, e, n in sl["host"] if n == full]


def count(ctx, name: str) -> int:
    return len(intervals(ctx, name))


def seconds(ctx, name: str):
    """Seconds inside the spans of ``name`` (their union), or None."""
    spans = intervals(ctx, name)
    if not spans:
        return None
    return sum(e - s for s, e in timing.merge(spans))


def idle_seconds(ctx, name: str):
    """Seconds inside the spans of ``name`` in which no device operation
    ran: each span's length less the union of the slice's operations
    clipped to it; None without such a span."""
    spans = intervals(ctx, name)
    if not spans:
        return None
    ops = [(s, e) for _, s, e in ctx["slice"]["ops"]]
    return sum((e - s) - timing.busy(ops, s, e)
               for s, e in timing.merge(spans))


def ms_per(ctx, value_s, root: str):
    """``value_s`` in milliseconds a span of ``root`` (a render, an
    iteration), or None."""
    n = count(ctx, root)
    if value_s is None or n == 0:
        return None
    return 1e3 * value_s / n
