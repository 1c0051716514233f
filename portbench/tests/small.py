"""Small rooms for the CPU tests: the cells' configurations and traffic
with the room, the IR and the fit cut so that a CPU run takes seconds."""

import copy

from portbench.harness import manifest


def shoebox(fit_steps=128):
    cfg = copy.deepcopy(manifest.config("shoebox_hall"))
    cfg["room"]["shell"] = [[0.0, 0.0, 0.0], [3.5, 3.2, 3.8]]
    cfg["ir_seconds"] = 0.05
    cfg["fit_steps"] = fit_steps
    return cfg


def columns():
    cfg = copy.deepcopy(manifest.config("columns_hall"))
    cfg["room"]["shell"] = [[0.0, 0.0, 0.0], [3.6, 3.0, 3.4]]
    cfg["room"]["columns"] = [[[1.3, 0.02, 1.1], [1.52, 2.98, 1.33]]]
    cfg["waveguide"]["cutoff_hz"] = 500.0
    cfg["ir_steps"] = 150
    return cfg


def traffic(name):
    t = copy.deepcopy(manifest.traffic(name))
    t["wall_margin_m"] = 0.6
    t["min_separation_m"] = 0.5
    return t
