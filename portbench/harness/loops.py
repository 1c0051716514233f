"""What every kind of traffic shares: the inputs a cell draws from its
configuration, traffic and seed, and the closed-loop window.

A traffic file names its ``kind``; ``kinds/<kind>.py`` is found by that
name and holds the kind's loop and its check:

- ``inputs(config, traffic, seed)``: everything drawn from the seed, built
  through :class:`Inputs`; the run and the control both take their inputs
  from it;
- ``Cell(torch, inp, device)``: the program's side, set up and warmed up at
  the cell's own shapes, with ``work_each`` (the work of one request),
  ``request(traced, timed)``, ``record(result)``, ``traced_slice()`` (the
  steps it ran), ``context()`` (what the metrics' readers read),
  ``failed()`` and ``hand_over(seed)`` (the outputs to judge, on the host,
  with the program's state freed);
- ``numbers(torch, inp, held, device)``: the plain reference's comparison,
  each number held to ``limits/<cell>.json``;
- ``FAULTS`` and ``control(torch, inp, device, fault)``: the control and the
  faults planted in the reference put in the program's place.

A new kind is a new file there, and a new mix of a kind a new traffic file.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import generator, scenes
from portbench.reference import waveguide as ref


def sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Inputs:
    """A room cell's inputs: the rates and the grid of its configuration, and
    the endless (source, receiver) draws of its seed."""

    def __init__(self, config, traffic, seed):
        self.config, self.traffic, self.seed = config, traffic, seed
        env = config["environment"]
        self.c = env["speed_of_sound"]
        self.density = env["acoustic_impedance"] / self.c
        self.fs = generator.mesh_rate(config)
        self.spacing = ref.grid_spacing(self.c, self.fs)
        self.fs_mesh = ref.mesh_rate(self.c, self.spacing)
        shell, _ = scenes.boxes(config)
        self.dims = ref.make_grid(shell[0], shell[1], self.spacing).dims
        self.nodes = int(np.prod(self.dims))
        self.positions = generator.positions(config, traffic, seed)


def shape(inp, chunk: int) -> dict:
    """The sizes the rooflines count from: the grid, the wall filters'
    order, the receiver's taps and the program's sub-steps a launch."""
    from portbench.reference import filters
    return {"dims": inp.dims, "order": filters.ORDER,
            "taps": 1 + len(ref.OFFSETS), "chunk": chunk}


def window(cell, seconds: float, timed: bool = False) -> dict:
    """Requests back to back from the window's start: the start, each
    request's (begin, end) among those that finished inside the window,
    the window's length and the work of one request."""
    start = time.perf_counter()
    requests = []
    while time.perf_counter() - start < seconds:
        begin = time.perf_counter()
        result = cell.request(timed=timed)
        end = time.perf_counter()
        if end - start > seconds:
            break
        cell.record(result)
        requests.append((begin, end))
    return {"start": start, "requests": requests, "seconds": seconds,
            "work_each": cell.work_each}
