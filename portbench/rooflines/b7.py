"""B7, the shoebox adjoint chunk kernel (``mega_chunk_bwd_kernel``).
Counted once per launch: the field and state cotangents in and out, the tap
cotangents in, the signal cotangent out; a sub-step the two cotangent
streams of the boundary planes out; 9 operations a node and 60 a
boundary-plane element a sub-step."""

from portbench.harness import manifest

KERNEL = "mega_chunk_bwd_kernel"
F32 = 4


def launch(shape):
    b2 = manifest.module("rooflines", "b2")
    x, y, z = shape["dims"]
    n, k, order = x * y * z, shape["chunk"], shape["order"]
    plane = b2.planes(shape["dims"])
    io = F32 * (4 * n + 2 * order * plane + k * (1 + shape["taps"])) \
        + k * F32 * (1 + order) * plane
    return k * (9 * n + 60 * plane), io
