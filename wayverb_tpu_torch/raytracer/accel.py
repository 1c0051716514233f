"""Voxel acceleration for ray–scene queries, and the backend choice.

Port of ``wayverb_tpu.raytracer.accel``.  The reference C++ marches a voxel
grid per ray inside its OpenCL kernels (``src/core/src/cl/voxel.cpp:85-156``
DDA, ``:197-258`` traversal + intersection).  Here an Amanatides–Woo DDA
walks ALL rays at once: each iteration gathers the (padded, fixed-K) triangle
list of every ray's current cell, runs one batched Möller–Trumbore over the
(R, K) block, and advances the rays that are not done to their next cell.
Work per bounce is O(R · K · cells visited) instead of O(R · T); control flow
is mask-based (rays that finish early ride along as masked rows).  The
reference's ``lax.while_loop`` is a Python ``while`` whose condition reads one
flag back from the device per iteration.

The grid is built on the host at setup with conservative AABB binning (a
superset of the reference C++'s triangle–cube overlap test: extra tests cost
a little speed, never correctness).

``auto_accel`` picks the backend: the dense (R, T) broadcast up to 100
triangles; above that the hand-written Möller–Trumbore kernels of
``raytracer.mt_kernels`` on a CUDA device and this voxel DDA on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.core.geometry import (EPSILON, TriangleSoup, norm3,
                                             ray_triangle_intersection)
from wayverb_tpu_torch.raytracer.mt_kernels import build_mt_triangles

DENSE_MAX_TRIANGLES = 100


@dataclasses.dataclass(frozen=True)
class RayGrid:
    """Uniform voxel grid over the scene.

    ``cells``: (C, K) int32 triangle ids, padded with -1 (C = rx·ry·rz, flat
    C-order).  ``lo``/``voxel``: grid origin and per-axis voxel size, (3,)
    float32.  ``res``: cells per axis (host-side ints).
    """

    cells: torch.Tensor
    lo: torch.Tensor
    voxel: torch.Tensor
    res: Tuple[int, int, int]

    @property
    def max_per_cell(self) -> int:
        return self.cells.shape[1]

    def to(self, device) -> "RayGrid":
        return RayGrid(self.cells.to(device), self.lo.to(device),
                       self.voxel.to(device), self.res)


def build_ray_grid(soup: TriangleSoup, resolution: Optional[int] = None,
                   pad: float = 1e-3) -> RayGrid:
    """Bin triangles into a uniform grid (host-side numpy, setup time); the
    tables lie on the CPU.

    ``resolution``: cells per axis (default ≈ cbrt(T/4), clamped to
    [4, 32] — a few triangles per cell on typical scenes).
    """
    verts = soup.vertices.cpu().numpy()
    tris = soup.triangles.cpu().numpy()
    T = len(tris)
    if resolution is None:
        resolution = int(np.clip(round((T / 4.0) ** (1.0 / 3.0)), 4, 32))
    res = (resolution, resolution, resolution)

    lo = verts.min(axis=0) - pad
    hi = verts.max(axis=0) + pad
    voxel = (hi - lo) / np.asarray(res)

    corners = verts[tris]                       # (T, 3, 3)
    tmin = corners.min(axis=1)                  # (T, 3)
    tmax = corners.max(axis=1)
    cmin = np.clip(((tmin - lo) / voxel).astype(np.int64), 0,
                   np.asarray(res) - 1)
    cmax = np.clip(((tmax - lo) / voxel).astype(np.int64), 0,
                   np.asarray(res) - 1)

    buckets: dict = {}
    for t in range(T):
        for ix in range(cmin[t, 0], cmax[t, 0] + 1):
            for iy in range(cmin[t, 1], cmax[t, 1] + 1):
                for iz in range(cmin[t, 2], cmax[t, 2] + 1):
                    buckets.setdefault(
                        (ix * res[1] + iy) * res[2] + iz, []).append(t)

    K = max((len(v) for v in buckets.values()), default=1)
    C = res[0] * res[1] * res[2]
    cells = np.full((C, K), -1, dtype=np.int32)
    for c, ids in buckets.items():
        cells[c, :len(ids)] = ids
    return RayGrid(cells=torch.from_numpy(cells),
                   lo=torch.from_numpy(lo.astype(np.float32)),
                   voxel=torch.from_numpy(voxel.astype(np.float32)), res=res)


def grid_intersection(origin, direction, grid: RayGrid, soup: TriangleSoup,
                      exclude_triangle=None, max_steps: Optional[int] = None):
    """Closest hit via batched voxel DDA; same contract as
    ``geometry.scene_intersection``: returns (t, tri_index, hit) each (R,).

    Parity: ``voxel.cpp:85-156`` (DDA setup/march) + ``:197-226`` (per-cell
    closest intersection with early exit once a hit lies inside the current
    cell).
    """
    R = origin.shape[0]
    device = origin.device
    res = torch.tensor(grid.res, dtype=torch.int32, device=device)
    if max_steps is None:
        max_steps = int(sum(grid.res)) + 2
    corners_all = soup.corners()                # (T, 3, 3)
    if exclude_triangle is None:
        exclude_triangle = torch.full((R,), -1, dtype=torch.int32,
                                      device=device)

    d = direction
    sgn = torch.where(d >= 0, 1, -1).to(torch.int32)            # (R, 3)
    nonzero = torch.abs(d) > 1e-20
    inv_d = torch.where(nonzero,
                        1.0 / torch.where(nonzero, d, torch.ones_like(d)),
                        torch.full_like(d, 1e20))

    rel = (origin - grid.lo) / grid.voxel
    cell = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int32), min=0),
                         res - 1)
    # parametric distance to the next boundary along each axis
    next_bound = (cell + (sgn > 0)).to(torch.float32) * grid.voxel + grid.lo
    tmax = (next_bound - origin) * inv_d                         # (R, 3)
    big = torch.full((), float("inf"), device=device)
    tmax = torch.where(nonzero, tmax, big)
    tdelta = torch.abs(grid.voxel * inv_d)

    best_t = torch.full((R,), float("inf"), device=device)
    best_tri = torch.zeros(R, dtype=torch.int32, device=device)
    found = torch.zeros(R, dtype=torch.bool, device=device)
    done = torch.zeros(R, dtype=torch.bool, device=device)
    o_rows, d_rows = origin[:, None, :], d[:, None, :]
    exclude_col = exclude_triangle[:, None]

    steps = 0
    while steps < max_steps and not bool(done.all()):
        flat = ((cell[:, 0] * grid.res[1] + cell[:, 1]) * grid.res[2]
                + cell[:, 2]).long()
        ids = grid.cells[flat]                           # (R, K)
        corners = corners_all[torch.clamp(ids, min=0).long()]   # (R,K,3,3)
        t, _, _, hit = ray_triangle_intersection(o_rows, d_rows, corners)
        valid = hit & (ids >= 0) & (ids != exclude_col) & (t > EPSILON)
        t = torch.where(valid, t, big)
        # argmin takes the first of equal minima, as jnp.argmin does
        k = torch.argmin(t, dim=-1, keepdim=True)
        t_cell = torch.gather(t, 1, k)[:, 0]
        tri_cell = torch.gather(ids, 1, k)[:, 0]

        better = (~done) & (t_cell < best_t)
        best_t = torch.where(better, t_cell, best_t)
        best_tri = torch.where(better, tri_cell, best_tri)
        found = found | (better & torch.isfinite(t_cell))

        # a hit is final once it lies within the current cell (closer cells
        # along the ray have all been visited)
        t_exit = torch.amin(tmax, dim=-1)
        done_hit = found & (best_t <= t_exit + 1e-5)

        # advance: step the axis with the smallest tmax
        onehot = F.one_hot(torch.argmin(tmax, dim=-1), 3)        # (R, 3)
        new_cell = cell + onehot.to(torch.int32) * sgn
        new_tmax = tmax + onehot.to(tmax.dtype) * tdelta
        out = torch.any((new_cell < 0) | (new_cell >= res), dim=-1)

        done = done | done_hit | out
        cell = torch.where(done[:, None], cell, new_cell)
        tmax = torch.where(done[:, None], tmax, new_tmax)
        steps += 1

    return torch.where(found, best_t, big), best_tri, found


def grid_line_of_sight(start, end, grid: RayGrid, soup: TriangleSoup,
                       exclude_triangle=None):
    """(R,) bool: segment start→end unobstructed (DDA closest-hit based)."""
    seg = end - start
    dist = norm3(seg)
    direction = seg / torch.clamp(dist[:, None], min=1e-20)
    t, _, any_hit = grid_intersection(start, direction, grid, soup,
                                      exclude_triangle=exclude_triangle)
    return (~any_hit) | (t >= dist * (1.0 - 1e-4))


def auto_accel(soup: TriangleSoup, device):
    """The intersection backend for this scene on ``device``, with its
    tables on that device.

    Scenes of at most 100 triangles (every shoebox) stay on the dense (R, T)
    broadcast: None.  Larger scenes take the Möller–Trumbore kernels on a
    CUDA device (``mt_kernels.MtTriangles``; above
    ``mt_kernels.CULL_MIN_TRIS`` triangles the builder adds the Morton-tile
    AABB cull) and the voxel DDA on the CPU (``RayGrid``), where gathers are
    cheap and the DDA does asymptotically less work.
    """
    if soup.num_triangles <= DENSE_MAX_TRIANGLES:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        return build_mt_triangles(soup).to(device)
    return build_ray_grid(soup).to(device)
