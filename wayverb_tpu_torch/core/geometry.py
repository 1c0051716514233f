"""Scene geometry for the waveguide leg: boxes and triangle soups.

Port of ``wayverb_tpu.core.geometry``: ``TriangleSoup``, ``Box``,
``box_scene``, ``scene_aabb``, the triangle normals and areas, mirroring,
the broadcast ray–scene queries (an (R, T) Möller–Trumbore, no per-ray
loops), the point-in-mesh parity vote (``points_inside``), the segment–sphere
test and the tetrahedron volume sum.

``Box`` mirrors the reference's float32 arithmetic on purpose: its centre is
a float32 value, and the mesh anchor is that centre, so both packages build
identical grids.

Parity: reference ``core/geo/*`` and ``core/src/cl/geometry.cpp`` (ray/tri
intersection, mirror), ``geo::get_scene_data(box)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

EPSILON = 1e-6


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

    def to(self, device) -> "TriangleSoup":
        return TriangleSoup(self.vertices.to(device),
                            self.triangles.to(device),
                            self.surfaces.to(device))


# Three-vector reductions as the CPU evaluates them, written as elementwise
# ops in a fixed order so that the card gives the same bits.  On the card a
# last-axis ``sum`` or ``vector_norm`` is one kernel that may contract or
# reorder, and its float32 ``sqrt`` can differ from the CPU's in the last
# bit; the ray tracer amplifies such an ulp over its bounces until card and
# CPU rays part (``chip_smoke.py`` phase 37).  ``torch.linalg.cross``
# gives the same bits on both devices as it is.

def sum3(v):
    """The CPU's ``torch.sum(v, dim=-1)`` of a (..., 3) tensor: (v0 + v1) +
    v2."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def dot3(a, b):
    """a · b over the last axis of broadcastable (..., 3) tensors."""
    return sum3(a * b)


def sqrt32(x):
    """√x of a float32 tensor, correctly rounded on every device (the
    square root taken in float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm3(v):
    """|v| over the last axis of a float32 (..., 3) tensor: the CPU's
    ``vector_norm``, a fused multiply-add chain x0², + x1², + x2² (each
    product exact in float64, each sum rounded to float32), then √.  Other
    dtypes take ``vector_norm``."""
    if v.dtype != torch.float32:
        return torch.linalg.vector_norm(v, dim=-1)
    d = v.double()
    acc = (d[..., 0] * d[..., 0]).float()
    for i in (1, 2):
        acc = (d[..., i] * d[..., i] + acc.double()).float()
    return sqrt32(acc)


def _unit(v):
    """v / max(|v|, 1e-20) along the last axis."""
    return v / torch.clamp(norm3(v)[..., None], min=1e-20)


def triangle_normals(soup: TriangleSoup, normalize: bool = True):
    """(T, 3) per-triangle normals (right-handed winding)."""
    c = soup.corners()
    n = torch.linalg.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
    return _unit(n) if normalize else n


def triangle_areas(soup: TriangleSoup):
    c = soup.corners()
    return 0.5 * norm3(torch.linalg.cross(c[:, 1] - c[:, 0],
                                          c[:, 2] - c[:, 0]))


def mirror_point(point, tri_corners):
    """Reflect ``point`` (..., 3) in the plane of a triangle (..., 3, 3)."""
    v0 = tri_corners[..., 0, :]
    n = _unit(torch.linalg.cross(tri_corners[..., 1, :] - v0,
                                 tri_corners[..., 2, :] - v0))
    d = dot3(n, point - v0)[..., None]
    return point - 2.0 * d * n


def _cross(a, b):
    """Cross product of broadcastable (..., 3) tensors."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ray_triangle_intersection(origin, direction, corners):
    """Möller–Trumbore, fully broadcast.

    origin/direction: (..., 3); corners: (..., 3, 3) broadcastable against
    them.  Returns ``(t, u, v, hit)`` where ``hit`` is a bool mask of valid
    front/back hits with ``t > EPSILON``.
    """
    v0 = corners[..., 0, :]
    e1 = corners[..., 1, :] - v0
    e2 = corners[..., 2, :] - v0
    pvec = _cross(direction, e2)
    det = dot3(e1, pvec)
    ok = torch.abs(det) > EPSILON
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    # small barycentric slack: rays crossing exactly on a shared edge must
    # hit at least one of the adjacent triangles, or they leak out of
    # watertight scenes and die
    slack = 1e-4
    hit = ok & (u >= -slack) & (v >= -slack) & (u + v <= 1.0 + slack) \
        & (t > EPSILON)
    return t, u, v, hit


# The dense closest-hit broadcast keeps about ten (rows, T) or (rows, T, 3)
# float32 intermediates alive at once (eager torch does not fuse them away as
# XLA does), so it walks its rows in blocks of at most this many (ray,
# triangle) pairs.  Each row's result depends on that row alone.  The limit
# keeps the tracer's dense branch (at most 100 triangles) in one block at
# 65,536 rays: 6.6 M pairs.
DENSE_MAX_PAIRS = 1 << 23


def _closest_of_rows(origin, direction, corners, exclude_triangle):
    t, _, _, hit = ray_triangle_intersection(
        origin[:, None, :], direction[:, None, :], corners[None])
    if exclude_triangle is not None:
        tri_ids = torch.arange(corners.shape[0],
                               device=origin.device)[None, :]
        hit = hit & (tri_ids != exclude_triangle[:, None])
    t_masked = torch.where(hit, t, torch.full_like(t, float("inf")))
    # argmin takes the first of equal minima, as jnp.argmin does
    idx = torch.argmin(t_masked, dim=-1)
    t_best = torch.gather(t_masked, 1, idx[:, None])[:, 0]
    return t_best, idx, torch.any(hit, dim=-1)


def scene_intersection(origin, direction, soup: TriangleSoup,
                       exclude_triangle=None):
    """Closest hit of rays (R, 3) against the whole scene.

    Returns ``(t, tri_index, hit)`` each of shape (R,).  ``exclude_triangle``
    (R,) int skips self-intersection with the launching triangle.  The rows
    are walked in blocks of at most DENSE_MAX_PAIRS (ray, triangle) pairs,
    which bounds the memory and changes no number.
    """
    corners = soup.corners()                                  # (T, 3, 3)
    R = origin.shape[0]
    rows = max(1, DENSE_MAX_PAIRS // max(corners.shape[0], 1))
    if R <= rows:
        return _closest_of_rows(origin, direction, corners, exclude_triangle)
    parts = [_closest_of_rows(
        origin[r0:r0 + rows], direction[r0:r0 + rows], corners,
        None if exclude_triangle is None else exclude_triangle[r0:r0 + rows])
        for r0 in range(0, R, rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def count_intersections(origin, direction, soup: TriangleSoup):
    """(R,) number of triangles each ray passes through (t > 0)."""
    _, _, _, hit = ray_triangle_intersection(
        origin[:, None, :], direction[:, None, :], soup.corners()[None])
    return torch.sum(hit, dim=-1)


# Fixed direction table for the point-in-mesh parity vote.  The reference C++
# (``core/src/cl/voxel.cpp:156-226``) uses 32 fixed pseudo-random unit
# vectors and a majority vote over odd crossing counts; the JAX package
# draws its own table from a fixed key, and these are its float32 values,
# so both packages vote with the same rays.
_PARITY_DIRECTIONS = (
    (-0.00047527250717394054, -0.9847056865692139, -0.17422546446323395),
    (0.5968388319015503, 0.19945192337036133, 0.777175784111023),
    (0.7111278176307678, 0.03650689125061035, -0.7021142244338989),
    (0.5269975066184998, 0.10833215713500977, -0.8429340124130249),
    (-0.16835632920265198, 0.7769031524658203, -0.6066940426826477),
    (-0.9751377701759338, -0.1623835563659668, -0.15079094469547272),
    (-0.3007239103317261, -0.05568289756774902, 0.9520843029022217),
    (-0.11448982357978821, 0.658332109451294, 0.7439696788787842),
    (-0.9346819519996643, -0.08503031730651855, 0.34516578912734985),
    (0.8313184380531311, 0.5516378879547119, -0.06786293536424637),
    (0.269249826669693, 0.8560540676116943, 0.4412209987640381),
    (0.5139167308807373, -0.4743368625640869, -0.7147685289382935),
    (-0.6779379844665527, -0.12054944038391113, -0.7251675128936768),
    (0.5607728362083435, -0.307833194732666, -0.7686172723770142),
    (-0.5933821797370911, -0.15646576881408691, -0.7895669341087341),
    (0.7676702737808228, -0.291839599609375, 0.5705365538597107),
    (-0.7355836629867554, 0.377352237701416, 0.5626028180122375),
    (-0.7176271677017212, -0.4906172752380371, -0.4942731261253357),
    (0.09253395348787308, 0.3947625160217285, 0.9141116142272949),
    (-0.8607093691825867, 0.49664926528930664, -0.11188782751560211),
    (0.6561362743377686, 0.41788506507873535, 0.6283767223358154),
    (0.9582609534263611, -0.16270661354064941, 0.23507976531982422),
    (0.7595062255859375, 0.5378425121307373, 0.3658904731273651),
    (-0.592570424079895, -0.32946181297302246, 0.7350613474845886),
    (-0.8291452527046204, -0.555194616317749, 0.06539970636367798),
    (0.8736832737922668, 0.13654088973999023, 0.46694129705429077),
    (0.014209321700036526, -0.9932975769042969, -0.1147083193063736),
    (0.1492035835981369, 0.8234848976135254, -0.5473672747612),
    (-0.07331234216690063, 0.8590579032897949, -0.5066012144088745),
    (-0.03074379824101925, 0.9950222969055176, 0.09479150176048279),
    (-0.9852278828620911, -0.08670306205749512, -0.14767752587795258),
    (-0.1818239539861679, 0.9645569324493408, -0.19123271107673645),
)
_NUM_PARITY_RAYS = len(_PARITY_DIRECTIONS)


def _parity_directions(dtype=torch.float32, device="cpu"):
    return torch.tensor(_PARITY_DIRECTIONS, dtype=dtype, device=device)


def points_inside(points, soup: TriangleSoup):
    """(P,) bool: is each point inside the (closed) mesh?

    Casts 32 fixed-direction rays per point and majority-votes on crossing
    parity — robust to rays grazing edges.  Runs on the device of
    ``points``; ``soup`` must lie there too.
    """
    dirs = _parity_directions(points.dtype, points.device)      # (D, 3)
    P = points.shape[0]
    origins = torch.repeat_interleave(points, _NUM_PARITY_RAYS, dim=0)
    directions = dirs.repeat(P, 1)                              # (P*D, 3)
    counts = count_intersections(origins, directions, soup)
    odd = (counts % 2).reshape(P, _NUM_PARITY_RAYS)
    return torch.sum(odd, dim=-1) * 2 > _NUM_PARITY_RAYS


def line_of_sight(start, end, soup: TriangleSoup, exclude_triangle=None):
    """(R,) bool: is the segment start→end unobstructed?

    ``exclude_triangle`` skips the triangle the segment starts on.
    """
    seg = end - start
    dist = norm3(seg)
    direction = seg / torch.clamp(dist[:, None], min=1e-20)
    t, _, any_hit = scene_intersection(start, direction, soup,
                                       exclude_triangle=exclude_triangle)
    return (~any_hit) | (t >= dist * (1.0 - 1e-4))


def line_segment_sphere_intersection(p0, p1, centre, radius):
    """bool (...,): does segment p0→p1 pass within ``radius`` of ``centre``?"""
    d = p1 - p0
    f = p0 - centre
    a = dot3(d, d)
    b = 2.0 * dot3(f, d)
    c = dot3(f, f) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = sqrt32(torch.where(ok, disc, torch.zeros_like(disc)))
    denom = torch.where(a > 0, 2.0 * a, torch.ones_like(a))
    t1 = (-b - sq) / denom
    t2 = (-b + sq) / denom
    in_range = ((t1 >= 0.0) & (t1 <= 1.0)) | ((t2 >= 0.0) & (t2 <= 1.0))
    return ok & in_range & (a > 0)


def tetrahedron_volume_sum(soup: TriangleSoup):
    """Signed-volume room estimate (zhang2001; reference reverb_time.h:107)."""
    c = soup.corners()
    six_v = dot3(c[:, 0], torch.linalg.cross(c[:, 1], c[:, 2]))
    return torch.abs(torch.sum(six_v)) / 6.0


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
