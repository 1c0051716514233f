"""The room of a configuration: its boxes as the harness hands them to both
sides, the triangles it gives the program, and the program's mesh.

A configuration's ``room`` names a shell box (``shell``: lo and hi corners
in metres) and any number of closed floor-to-ceiling ``columns`` (each lo
and hi).  A room without columns is handed to the program as a box, which
the program meshes with its analytic shoebox test; a room with columns is
handed over as a closed triangle soup: the shell's faces cut into
``shell_div`` x ``shell_div`` quads and each column's into ``column_div`` x
``column_div``, two triangles a quad, walls facing the room, all of one
material.
"""

from __future__ import annotations

import numpy as np


def boxes(config: dict):
    """((lo, hi) of the shell, [(lo, hi) of each column])."""
    room = config["room"]
    shell = tuple(tuple(float(v) for v in c) for c in room["shell"])
    cols = [tuple(tuple(float(v) for v in c) for c in col)
            for col in room.get("columns", [])]
    return shell, cols


def _quad(corner, eu, ev, div, flip):
    us = np.linspace(0.0, 1.0, div + 1, dtype=np.float32)
    verts = (corner[None, None] + us[:, None, None] * eu[None, None]
             + us[None, :, None] * ev[None, None]).reshape(-1, 3)
    tris = []
    for i in range(div):
        for j in range(div):
            a, b = i * (div + 1) + j, (i + 1) * (div + 1) + j
            tris += [(a, b + 1, b), (a, a + 1, b + 1)] if flip else \
                [(a, b, b + 1), (a, b + 1, a + 1)]
    return verts, np.asarray(tris, np.int32)


def _box_faces(lo, hi, div):
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    d = hi - lo
    for axis in range(3):
        a1, a2 = [a for a in range(3) if a != axis]
        eu, ev = np.zeros(3, np.float32), np.zeros(3, np.float32)
        eu[a1], ev[a2] = d[a1], d[a2]
        far = lo.copy()
        far[axis] += d[axis]
        yield _quad(lo, eu, ev, div, False)
        yield _quad(far, eu, ev, div, True)


def soup_arrays(config: dict):
    """(vertices (V, 3) float32, triangles (T, 3) int32) of the room."""
    room = config["room"]
    shell, cols = boxes(config)
    parts = list(_box_faces(*shell, room["shell_div"]))
    for col in cols:
        parts += list(_box_faces(*col, room["column_div"]))
    verts, tris, off = [], [], 0
    for v, t in parts:
        verts.append(v)
        tris.append(t + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(tris)


def absorption_table(absorption) -> np.ndarray:
    """(1, bands) table of the one material."""
    return np.asarray(absorption, dtype=np.float64).reshape(1, -1)


def program_mesh(config: dict, sample_rate: float, device, timings: dict):
    """The program's mesh of the room at ``sample_rate``; ``timings``
    receives the seconds of its set-up stages."""
    import torch

    from wayverb_tpu_torch.core.geometry import Box, TriangleSoup, box_scene
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

    env = config["environment"]
    spacing = grid_spacing(env["speed_of_sound"], 1.0 / sample_rate)
    absorption = absorption_table(config["absorption"])
    shell, cols = boxes(config)
    if not cols:
        box = Box(*shell)
        return wgrun.compute_mesh(box_scene(box), absorption, spacing,
                                  sample_rate, scene_box=box, device=device,
                                  timings=timings)
    verts, tris = soup_arrays(config)
    soup = TriangleSoup(torch.as_tensor(verts), torch.as_tensor(tris),
                        torch.zeros(len(tris), dtype=torch.int32))
    return wgrun.compute_mesh(soup, absorption, spacing, sample_rate,
                              device=device, timings=timings)
