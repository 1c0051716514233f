"""Seconds of the boundary structure's assembly in the program's mesh set-up
(compute_mesh's structure_s)."""

LAYER = "host set-up: waveguide.run.compute_mesh, waveguide.setup"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["timings"].get("structure_s")
