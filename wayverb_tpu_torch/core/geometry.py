"""Scene geometry for the waveguide leg: boxes and triangle soups.

Port of ``wayverb_tpu.core.geometry`` (``TriangleSoup``, ``Box``,
``box_scene``, ``scene_aabb``).  The ray-intersection functions move with
the ray leg.

``Box`` mirrors the reference's float32 arithmetic on purpose: its centre is
a float32 value, and the mesh anchor is that centre, so both packages build
identical grids.

Parity: reference ``core/geo/*`` (``geo::get_scene_data(box)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TriangleSoup:
    """Scene geometry: vertex positions + per-triangle vertex/surface indices.

    ``vertices``: (V, 3) float, ``triangles``: (T, 3) int vertex indices,
    ``surfaces``: (T,) int material indices.
    """

    vertices: torch.Tensor
    triangles: torch.Tensor
    surfaces: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    def corners(self) -> torch.Tensor:
        """(T, 3, 3): the three vertex positions of each triangle."""
        return self.vertices[self.triangles.long()]


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box (host-side metadata; corners are plain tuples)."""

    min_corner: Any
    max_corner: Any

    def _corner(self, c) -> torch.Tensor:
        return torch.tensor(c, dtype=torch.float32, device="cpu")

    def dimensions(self) -> torch.Tensor:
        return self._corner(self.max_corner) - self._corner(self.min_corner)

    def centre(self) -> torch.Tensor:
        return 0.5 * (self._corner(self.max_corner)
                      + self._corner(self.min_corner))

    def volume(self) -> float:
        d = self.dimensions()
        return float(d[0] * d[1] * d[2])

    def surface_area(self) -> float:
        d = self.dimensions()
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def scene_aabb(soup: TriangleSoup) -> Box:
    v = soup.vertices
    return Box(tuple(map(float, v.min(dim=0).values)),
               tuple(map(float, v.max(dim=0).values)))


def box_scene(box: Box, surface_index: int = 0,
              per_wall_surfaces=None) -> TriangleSoup:
    """A 12-triangle shoebox with inward-facing geometry (host tensors).

    ``per_wall_surfaces``: optional (6,) material indices in wall order
    (x-lo, x-hi, y-lo, y-hi, z-lo, z-hi).
    """
    lo = torch.tensor(box.min_corner, dtype=torch.float32, device="cpu")
    hi = torch.tensor(box.max_corner, dtype=torch.float32, device="cpu")
    # 8 corners, bit i of index = axis i at max
    corners = torch.stack([
        torch.where(torch.tensor([bool((i >> a) & 1) for a in range(3)],
                                 device="cpu"), hi, lo)
        for i in range(8)
    ])
    quads = [(0, 2, 6, 4), (1, 5, 7, 3), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 1, 3, 2), (4, 6, 7, 5)]
    tris = []
    for (a, b, c, d) in quads:
        tris.append((a, b, c))
        tris.append((a, c, d))
    triangles = torch.tensor(tris, dtype=torch.int32, device="cpu")
    if per_wall_surfaces is not None:
        surfaces = torch.repeat_interleave(
            torch.tensor(per_wall_surfaces, dtype=torch.int32, device="cpu"),
            2)
    else:
        surfaces = torch.full((len(tris),), surface_index, dtype=torch.int32,
                              device="cpu")
    return TriangleSoup(corners, triangles, surfaces)
