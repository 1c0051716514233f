"""One short steady slice under ``torch.profiler``: the device operations
(kernels, copies, sets) with their times, the benchmark's own spans
(``record_function("portbench.<name>")``) and the host operations, all on
the profiler's clock, read from its raw events without building its tables.
"""

from __future__ import annotations

import bisect
import contextlib

PREFIX = "portbench."


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span, recorded only while a slice is profiled."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(PREFIX + name):
        yield


def _is_device(e, cuda) -> bool:
    if e.device_type() != cuda:
        return False
    if e.name().startswith(PREFIX):
        return False
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or "annotation" not in str(kind()).lower()


def run(torch, fn) -> dict:
    """Profile ``fn()`` inside a ``slice`` span ended by a synchronize; the
    slice's device ops (name, start, end), benchmark spans and host ops
    (start, end, name), in seconds on the profiler's clock, and its
    bounds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("slice", True):
            fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, host = [], [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        name = e.name()
        if _is_device(e, cuda):
            ops.append((name, s, t))
        elif e.device_type() != cuda:
            if name == PREFIX + "slice":
                lo, hi = s, t
            elif name.startswith(PREFIX):
                spans.append((s, t, name[len(PREFIX):]))
            else:
                host.append((s, t, name))
    if lo is None:
        raise RuntimeError("the profiler recorded no slice span")
    ops = [o for o in ops if o[2] > lo and o[1] < hi]
    return {"ops": ops, "spans": spans, "host": sorted(host), "lo": lo,
            "hi": hi}


def innermost(host_sorted, t, reach: int = 64):
    """The host op that holds ``t`` and started last (the innermost of
    nested ops), looking back at most ``reach`` ops; None when the host
    was in Python."""
    i = bisect.bisect_right(host_sorted, (t, float("inf"), "")) - 1
    for j in range(i, max(i - reach, -1), -1):
        s, e, name = host_sorted[j]
        if s <= t < e:
            return name
    return None
