"""Seconds of the box's face surfaces, regions and plane spec in the
program's mesh set-up (compute_mesh's regions_s, the ``setup.regions``
span)."""

LAYER = "host set-up: waveguide.run.compute_mesh, waveguide.setup"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["timings"].get("regions_s")
