"""B6, the shoebox chunk kernel in gradient mode (``mega_chunk_kernel``
with its residuals): B2's work and bytes, and four boundary-plane stacks of
residuals written a sub-step."""

from portbench.harness import manifest

KERNEL = "mega_chunk_kernel"
F32 = 4


def launch(shape):
    b2 = manifest.module("rooflines", "b2")
    ops, io = b2.launch(shape)
    return ops, io + shape["chunk"] * F32 * 4 * b2.planes(shape["dims"])
