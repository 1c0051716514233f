"""Seconds of the inside test in the program's mesh set-up (compute_mesh's
classify_s)."""

LAYER = "host set-up: waveguide.run.compute_mesh, waveguide.setup"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["timings"].get("classify_s")
