"""Procedural scenes that are not shoeboxes.

Port of ``wayverb_tpu.raytracer.scenes``: a deterministic concert-hall
generator, a closed shoebox shell with closed floor-to-ceiling columns.  At
``procedural_hall(2, 4, 1)`` it has 96 triangles, which the dense ray branch
serves; the default (5,448 triangles) and ``procedural_hall_large`` (97,068)
take the ray acceleration of ``raytracer.accel`` and
``raytracer.mt_kernels``.  The geometry is built in numpy and handed over
with ``convert.soup_from_numpy``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from wayverb_tpu_torch.convert import soup_from_numpy
from wayverb_tpu_torch.core.geometry import TriangleSoup


def _tessellated_quad(corner, edge_u, edge_v, div_u, div_v, flip=False):
    """Grid-subdivided quad → (verts (N,3), tris (M,3)) float/int arrays."""
    corner = np.asarray(corner, np.float32)
    edge_u = np.asarray(edge_u, np.float32)
    edge_v = np.asarray(edge_v, np.float32)
    us = np.linspace(0.0, 1.0, div_u + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, div_v + 1, dtype=np.float32)
    verts = (corner[None, None]
             + us[:, None, None] * edge_u[None, None]
             + vs[None, :, None] * edge_v[None, None]).reshape(-1, 3)
    tris = []
    for i in range(div_u):
        for j in range(div_v):
            a = i * (div_v + 1) + j
            b = (i + 1) * (div_v + 1) + j
            if flip:
                tris.append((a, b + 1, b))
                tris.append((a, a + 1, b + 1))
            else:
                tris.append((a, b, b + 1))
                tris.append((a, b + 1, a + 1))
    return verts, np.asarray(tris, np.int32)


def _tessellated_box(lo, hi, div, flip=False):
    """Closed box with each face subdivided div×div."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    d = hi - lo
    faces = []
    for axis in range(3):
        a1, a2 = [a for a in range(3) if a != axis]
        eu = np.zeros(3, np.float32)
        ev = np.zeros(3, np.float32)
        eu[a1] = d[a1]
        ev[a2] = d[a2]
        c_lo = lo.copy()
        c_hi = lo.copy()
        c_hi[axis] += d[axis]
        faces.append(_tessellated_quad(c_lo, eu, ev, div, div, flip=flip))
        faces.append(_tessellated_quad(c_hi, eu, ev, div, div,
                                       flip=not flip))
    verts_list, tris_list = [], []
    off = 0
    for v, t in faces:
        verts_list.append(v)
        tris_list.append(t + off)
        off += len(v)
    return np.concatenate(verts_list), np.concatenate(tris_list)


def procedural_hall(shell_div: int = 20, n_columns: int = 6,
                    column_div: int = 3, size=(20.0, 8.0, 15.0),
                    device="cpu") -> Tuple[TriangleSoup, int]:
    """Deterministic concert-hall-scale closed scene.

    A ``size`` shoebox shell tessellated ``shell_div``² per face plus
    ``n_columns`` closed floor-to-ceiling columns.  Default ≈ 5.2k
    triangles.  Returns (soup, num_triangles); all triangles use surface 0.
    """
    verts_list, tris_list = [], []
    off = 0

    v, t = _tessellated_box((0.0, 0.0, 0.0), size, shell_div)
    verts_list.append(v)
    tris_list.append(t + off)
    off += len(v)

    rng = np.random.default_rng(2026)
    W, H, D = size
    for k in range(n_columns):
        cx = float(rng.uniform(0.15, 0.85)) * W
        cz = float(rng.uniform(0.15, 0.85)) * D
        r = 0.4
        v, t = _tessellated_box((cx - r, 0.02, cz - r),
                                (cx + r, H - 0.02, cz + r), column_div)
        verts_list.append(v)
        tris_list.append(t + off)
        off += len(v)

    verts = np.concatenate(verts_list)
    tris = np.concatenate(tris_list)
    soup = soup_from_numpy(verts, tris, np.zeros(len(tris), np.int32),
                           device=device)
    return soup, int(len(tris))


def procedural_hall_large(shell_div: int = 85, n_columns: int = 24,
                          column_div: int = 6, size=(20.0, 8.0, 15.0),
                          device="cpu") -> Tuple[TriangleSoup, int]:
    """~9e4-triangle variant of ``procedural_hall``: the triangle counts of
    loaded concert-hall models."""
    return procedural_hall(shell_div=shell_div, n_columns=n_columns,
                           column_div=column_div, size=size, device=device)
