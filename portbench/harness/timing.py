"""Rates and device-activity arithmetic, on plain numbers so that the tests
can hold them to synthetic intervals.

A closed loop's rate is the work of every request completed inside the
window over the time from the window's start to the last such completion;
a request still running when the window closes counts for nothing, and a
stall anywhere inside the window lowers the rate.  Device busy time is the
union of the device operations' intervals; idle time is the rest of the
slice, cut into gaps and labelled by the host span open at each gap's start.
"""

from __future__ import annotations

from collections import defaultdict


def closed_loop_rate(start: float, ends, window: float, work_each: float):
    """(rate, completed): the work of the requests that ended by ``start +
    window`` over the time from ``start`` to the last of them."""
    done = [e for e in ends if e - start <= window]
    if not done:
        return None, 0
    return len(done) * work_each / (max(done) - start), len(done)


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo, hi) -> float:
    """Length of the union of the intervals clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merge(intervals))


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def label_at(spans, t):
    """The innermost (shortest) labelled span that holds ``t``, or None.
    ``spans``: (start, end, label)."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def idle_by_label(intervals, lo, hi, label, top=10):
    """[[label, idle seconds], ...] of the labels with most idle time: the
    gaps of [lo, hi] labelled by ``label(gap start)`` (times in
    seconds)."""
    total = defaultdict(float)
    for s, e in gaps(intervals, lo, hi):
        total[label(s)] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:top]


def top_ops(ops, top=10):
    """[[name, seconds], ...] of the device operations that took most time,
    summed by name.  ``ops``: (name, start, end) in seconds."""
    total = defaultdict(float)
    for name, s, e in ops:
        total[name] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:top]
