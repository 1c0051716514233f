"""B8, the general mesh's dense weighted step (``mesh_weighted_step_kernel``),
one step a launch: cur, prev and the int32 neighbour code in, the next field
out; 15 operations a node (6 multiplies and 6 adds, two multiplies and a
subtract)."""

KERNEL = "mesh_weighted_step_kernel"


def launch(shape):
    x, y, z = shape["dims"]
    n = x * y * z
    return 15 * n, 16 * n
