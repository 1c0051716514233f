"""B2, the shoebox chunk kernel (``mega_chunk_kernel``, no residuals): K
sub-steps of the box in one launch.  Counted once per launch: cur, prev, the
six boundary planes' filter state and pressures in and out, the signal in
and the taps out; per sub-step 8 operations a node (6 adds, a multiply, a
subtract) and 40 a boundary-plane element."""

KERNEL = "mega_chunk_kernel"
F32 = 4


def planes(dims) -> int:
    """Elements of the six stacked boundary planes, each padded to
    (max(X, Y), max(Y, Z))."""
    x, y, z = dims
    return 6 * max(x, y) * max(y, z)


def launch(shape):
    """(operations, bytes) of one launch of ``shape['chunk']`` sub-steps."""
    x, y, z = shape["dims"]
    n, k, order = x * y * z, shape["chunk"], shape["order"]
    plane = planes(shape["dims"])
    io = F32 * (4 * n + 2 * (order + 3) * plane + k * (1 + shape["taps"]))
    return k * (8 * n + 40 * plane), io
