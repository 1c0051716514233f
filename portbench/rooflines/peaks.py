"""The least time an NVIDIA H100 SXM could take for a piece of work: the
larger of its bytes over the HBM rate and its float32 operations over the
float32 rate outside the tensor cores (NVIDIA's data sheet, at 700 W)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_us(n_bytes: float, ops: float):
    """(microseconds, "bytes" or "operations")."""
    t_bytes = 1e6 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e6 * ops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
