"""The least time an H100 could take for a piece of work.

One rule for every kernel's bound: the larger of the bytes the work must
move (each input read once, each output written once) over the memory rate,
and its float32 operations over the float32 rate.  The rates are NVIDIA's
data sheet for the H100 SXM.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_us(n_bytes: float, ops: float):
    """(µs, "bytes" or "operations"): the larger of ``n_bytes`` over the
    memory rate and ``ops`` float32 operations over the float32 rate, and
    which of the two it is."""
    t_bytes = 1e6 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e6 * ops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
