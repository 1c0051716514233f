"""What the metrics' readers share: the window's closed-loop rate, the
traced slice's device operations by kernel, and the rooflines of
``rooflines/<name>.py``.  A per-layer reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

import re

from portbench.harness import manifest, timing


def rate(ctx):
    """The work of the requests that finished inside the window over the
    time from its start to the last of them."""
    w = ctx["window"]
    value, _ = timing.closed_loop_rate(w["start"],
                                       [end for _, end in w["requests"]],
                                       w["seconds"], w["work_each"])
    return value


def _is_kernel(op_name: str, kernel: str) -> bool:
    return re.search(r"(^|[\s:])" + re.escape(kernel) + r"(\(|<|$)",
                     op_name) is not None


def kernel_ops(ctx, kernel: str):
    sl = ctx.get("slice")
    if not sl:
        return []
    return [o for o in sl["ops"] if _is_kernel(o[0], kernel)]


def roofline_pct(ctx, rooflines):
    """100 x the launches' bound time over their measured device time."""
    if not ctx.get("slice"):
        return None
    bound = measured = 0.0
    peaks = manifest.module("rooflines", "peaks")
    for name in rooflines:
        mod = manifest.module("rooflines", name)
        ops = kernel_ops(ctx, mod.KERNEL)
        flops, nbytes = mod.launch(ctx["shape"])
        bound += len(ops) * peaks.bound_us(nbytes, flops)[0] * 1e-6
        measured += sum(e - s for _, s, e in ops)
    return 100.0 * bound / measured if measured > 0 else None


def idle_pct(ctx):
    sl = ctx.get("slice")
    if not sl or not sl["ops"]:
        return None
    busy = timing.busy([(s, e) for _, s, e in sl["ops"]], sl["lo"], sl["hi"])
    return 100.0 * (1.0 - busy / (sl["hi"] - sl["lo"]))


def launches_per_step(ctx):
    sl = ctx.get("slice")
    if not sl or not sl["ops"]:
        return None
    return len(sl["ops"]) / sl["steps"]


def other_device_us_per_step(ctx, rooflines):
    """Device time a step of the operations outside the named kernels."""
    sl = ctx.get("slice")
    if not sl or not sl["ops"]:
        return None
    names = [manifest.module("rooflines", r).KERNEL for r in rooflines]
    other = sum(e - s for n, s, e in sl["ops"]
                if not any(_is_kernel(n, k) for k in names))
    return 1e6 * other / sl["steps"]


def mean_ms(values):
    return 1e3 * sum(values) / len(values) if values else None
