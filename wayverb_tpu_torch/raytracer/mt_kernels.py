"""Ray–triangle intersection for large scenes: tiled Möller–Trumbore.

Port of ``wayverb_tpu.raytracer.mt_pallas`` (the reference names the module
after its Pallas TPU kernels).  The dense broadcast
(``geometry.scene_intersection``) materialises (R, T, 3) intermediates in
device memory; here every ray keeps a running (closest t, triangle id) pair
while the triangles stream past in tiles of ``TB``, so traffic is linear in
R + T and the work is pure float32 arithmetic (46 operations a pair, and
about 14 compares and selects).

    closest:         for each ray, min over all triangles of the
                     Möller–Trumbore t, first triangle id among equal t
    closest, culled: the same on Morton-sorted triangles, behind a gate per
                     (tile of ``RB`` sorted rays, tile of ``TB`` triangles):
                     the pair's arithmetic runs only if some ray of the ray
                     tile can reach the triangle tile's bounding box closer
                     than its running best

Each has a hand-written CUDA kernel for Hopper (``csrc/ray_mt_closest.cu``,
``csrc/ray_mt_closest_culled.cu``) and a plain torch version beside it
(``_closest_plain``, ``_closest_culled_plain``) with the same order of
operations, tiles, padding and tie rules.  ``mt_closest`` launches the kernel
on CUDA tensors (or raises) and runs the plain version on CPU tensors;
launches are counted in ``mt_closest.launches`` (all-pairs kernel) and
``mt_closest.culled_launches``.  The culled kernel spreads each gate tile
over a thread-block cluster of ``CLUSTER`` CTAs (fixed when it is compiled),
each scanning a share of every triangle tile the gate lets through; the
partial hits are merged before the next vote, so the result is the
sequential gate's to the bit.  The all-pairs kernel gives each block of
rays a cluster of ``B3_CLUSTER`` CTAs, each scanning one of
``b3_shares(num)`` from "no hit yet", and merges the partial hits once.
Both skip, warp by warp, the triangles that ``_skip_tests_plain`` shows no
ray of the warp can hit.

No gradient: hit indices and parameters are piecewise constant in the
geometry, and the tracer's differentiable quantities (band energies) flow
through the material tables, not through hit coordinates.

Parity oracle: ``geometry.ray_triangle_intersection`` (identical constants:
EPSILON, barycentric slack 1e-4).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch._build import load, load_entry
from wayverb_tpu_torch.core.geometry import EPSILON, TriangleSoup, norm3

SLACK = 1e-4          # barycentric edge slack (geometry.ray_triangle_…)
RB = 512              # rays per gate tile of the culled kernel
TB = 1024             # triangles per tile: padding of ``packed``, tile boxes
BIG = 3.4e38
CULL_MIN_TRIS = 8192   # below this the all-pairs kernel wins outright
CLUSTER = 8            # CTAs of the cluster that owns one gate tile (B4's
#                        kCluster, fixed in csrc/ray_mt_closest_culled.cu)
B3_CLUSTER = 2         # CTAs of the cluster that owns one block of rays
#                        in the all-pairs kernel, CTA c scanning the
#                        triangles b3_shares(num)[c] (B3's kCluster, fixed
#                        in csrc/ray_mt_closest.cu)


@dataclasses.dataclass(frozen=True)
class MtTriangles:
    """Packed triangle data for the MT kernels: (9, Tpad) float32 rows =
    (v0 | e1 | e2) components, triangles along the row; padded columns are
    degenerate (all zero ⇒ det 0 ⇒ miss).

    For scenes above CULL_MIN_TRIS the builder Morton-sorts triangles by
    centroid so each TB-tile is a compact spatial blob, and ships per-tile
    AABBs plus the sort permutation: the culled kernel slab-tests each ray
    tile against the tile box and skips the arithmetic for tiles no ray can
    touch (the replacement for the reference C++'s per-ray voxel walk,
    ``src/core/src/cl/voxel.cpp:197-258``)."""

    packed: torch.Tensor                          # (9, Tpad) f32
    num: int                                      # true triangle count
    tile_boxes: Optional[torch.Tensor] = None     # (nT, 8) f32 [lo, hi, 0, 0]
    perm: Optional[torch.Tensor] = None           # (Tpad,) int32 sorted→orig
    inv_perm: Optional[torch.Tensor] = None       # (T,) int32 orig→sorted
    scene_lo: Optional[torch.Tensor] = None       # (3,) f32 ray sort frame
    scene_inv_ext: Optional[torch.Tensor] = None  # (3,) f32

    @property
    def culled(self) -> bool:
        return self.tile_boxes is not None

    def to(self, device) -> "MtTriangles":
        move = lambda x: None if x is None else x.to(device)  # noqa: E731
        return MtTriangles(move(self.packed), self.num,
                           move(self.tile_boxes), move(self.perm),
                           move(self.inv_perm), move(self.scene_lo),
                           move(self.scene_inv_ext))


def _morton3(q):
    """Interleave 10-bit xyz → 30-bit Morton codes ((N, 3) uint32 in)."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
            | (spread(q[:, 2]) << 2))


def build_mt_triangles(soup: TriangleSoup,
                       cull: Optional[bool] = None) -> MtTriangles:
    """Pack the soup for the MT kernels (host-side numpy, setup time); the
    tables lie on the CPU.  ``cull``: add the Morton sort and tile boxes
    (default: above CULL_MIN_TRIS triangles)."""
    c = soup.corners().cpu().numpy().astype(np.float32)     # (T, 3, 3)
    T = c.shape[0]
    if cull is None:
        cull = T > CULL_MIN_TRIS

    perm = inv_perm = tile_boxes = scene_lo = scene_inv_ext = None
    if cull:
        lo = c.reshape(-1, 3).min(axis=0)
        hi = c.reshape(-1, 3).max(axis=0)
        ext = np.maximum(hi - lo, 1e-9)
        cent = c.mean(axis=1)
        q = np.clip(((cent - lo) / ext) * 1023.0, 0, 1023).astype(
            np.uint32)
        order = np.argsort(_morton3(q), kind="stable")
        c = c[order]
        scene_lo = torch.from_numpy(lo)
        scene_inv_ext = torch.from_numpy((1.0 / ext).astype(np.float32))

    v0 = c[:, 0]
    e1 = c[:, 1] - v0
    e2 = c[:, 2] - v0
    packed = np.concatenate([v0.T, e1.T, e2.T], axis=0)     # (9, T)
    Tpad = -(-T // TB) * TB
    packed = np.pad(packed, ((0, 0), (0, Tpad - T)))

    if cull:
        perm_np = np.full(Tpad, -1, np.int32)
        perm_np[:T] = order.astype(np.int32)
        inv = np.empty(T, np.int32)
        inv[order] = np.arange(T, dtype=np.int32)
        nT = Tpad // TB
        boxes = np.zeros((nT, 8), np.float32)
        for ti in range(nT):
            blk = c[ti * TB:(ti + 1) * TB].reshape(-1, 3)
            if len(blk) == 0:
                boxes[ti, :3] = 1.0     # empty tile: inverted box misses
                boxes[ti, 3:6] = 0.0
            else:
                boxes[ti, :3] = blk.min(axis=0)
                boxes[ti, 3:6] = blk.max(axis=0)
        tile_boxes = torch.from_numpy(boxes)
        perm = torch.from_numpy(perm_np)
        inv_perm = torch.from_numpy(inv)
    return MtTriangles(packed=torch.from_numpy(np.ascontiguousarray(packed)),
                       num=T, tile_boxes=tile_boxes, perm=perm,
                       inv_perm=inv_perm, scene_lo=scene_lo,
                       scene_inv_ext=scene_inv_ext)


# ---------------------------------------------------------------------------
# the plain versions

def _mt_terms(o, d, tile):
    """The Möller–Trumbore terms of every (ray, triangle) pair of a tile,
    component by component, every product and sum on its own and left to
    right as the kernels compute them: (det, ok = |det| > EPSILON, 1 / det
    where ok and 0 elsewhere, and the dividends du, dv, dt of u, v, t)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]               # (rows, 1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = tile[0:1], tile[1:2], tile[2:3]            # (1, TB)
    e1x, e1y, e1z = tile[3:4], tile[4:5], tile[5:6]
    e2x, e2y, e2z = tile[6:7], tile[7:8], tile[8:9]

    # pvec = d × e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > EPSILON
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                torch.ones_like(det)),
                          torch.zeros_like(det))
    # tvec = o − v0
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    du = tx * px + ty * py + tz * pz
    # qvec = tvec × e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    dv = dx * qx + dy * qy + dz * qz
    dt = e2x * qx + e2y * qy + e2z * qz
    return det, ok, inv_det, du, dv, dt


def _mt_hits(o, d, exclude, tile, base: int, num: int):
    """(hit, t) over (rays, triangles of the tile): the Möller–Trumbore
    test with the slack, the padding and the excludes."""
    _, ok, inv_det, du, dv, dt = _mt_terms(o, d, tile)
    u, v, t = du * inv_det, dv * inv_det, dt * inv_det
    ids = base + torch.arange(tile.shape[1], dtype=torch.int32,
                              device=tile.device)[None, :]     # (1, TB)
    hit = ok & (u >= -SLACK) & (v >= -SLACK) & (u + v <= 1.0 + SLACK) \
        & (t > EPSILON) & (ids < num) & (ids != exclude[:, None])
    return hit, t


def _mt_tile(o, d, exclude, tile, base: int, num: int, best_t, best_i):
    """One (ray block, triangle tile) of the closest-hit scan: ``_mt_hits``,
    then the running minimum (strictly-less update; the first id among
    equal t of a tile)."""
    hit, t = _mt_hits(o, d, exclude, tile, base, num)
    t_masked = torch.where(hit, t, torch.full_like(t, BIG))
    # argmin takes the first of equal minima, as the kernels' scan does
    k = torch.argmin(t_masked, dim=1, keepdim=True)            # (rows, 1)
    t_best = torch.gather(t_masked, 1, k)[:, 0]
    i_best = (base + k[:, 0]).to(torch.int32)
    better = t_best < best_t
    return (torch.where(better, t_best, best_t),
            torch.where(better, i_best, best_i))


# 2**100: at or above it |det| passes both skip tests (1 / det could be
# subnormal, and the margins' argument would not hold)
SKIP_BIG_DET = 1.2676506e30


def _skip_tests_plain(o, d, tile):
    """(pass_u, pass_uv) over (rays, triangles of the tile): the tests the
    kernels' scan (``wv::mt_scan_tile``, csrc/ray_mt.cuh) takes before the
    IEEE reciprocal, in its float32 operations.  A warp skips a triangle
    when none of its lanes passes test 1 (u), or none passes test 2 (u, v
    and u + v).  A hit has u >= -1e-4, v >= -1e-4 and u + v <= 1 + 1e-4
    with u = du * (1 / det) and v = dv * (1 / det) each rounded twice, so
    with sdu, sdv = du, dv times the sign of det its lane has

        sdu >= -2e-4 * |det|,  sdu <= 1.0006 * |det|              (test 1)
        sdv >= -2e-4 * |det|,  sdu + sdv <= 1.0006 * |det|        (test 2)

    (the margins exceed every rounding while 1 / det is a normal float;
    |det| >= SKIP_BIG_DET passes both).  Every hit passes both tests, so
    skipping changes no bit of the result."""
    det, ok, _, du, dv, _ = _mt_terms(o, d, tile)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                 device=det.device)
    sdu = torch.where(det < 0, -du, du)
    sdv = torch.where(det < 0, -dv, dv)
    adet = torch.abs(det)
    big = adet >= f32(SKIP_BIG_DET)
    near_u = (sdu >= f32(-2e-4) * adet) & (sdu <= f32(1.0006) * adet)
    near_uv = near_u & (sdv >= f32(-2e-4) * adet) \
        & (sdu + sdv <= f32(1.0006) * adet)
    return ok & (big | near_u), ok & (big | near_uv)


def _ray_blocks(origin, direction, exclude):
    """The rays in blocks of RB rows, the last one padded with zero rays as
    the kernels pad it (a zero direction has det 0 everywhere and misses)."""
    R = origin.shape[0]
    for r0 in range(0, R, RB):
        rows = min(RB, R - r0)
        pad = RB - rows
        yield (r0, rows, F.pad(origin[r0:r0 + rows], (0, 0, 0, pad)),
               F.pad(direction[r0:r0 + rows], (0, 0, 0, pad)),
               F.pad(exclude[r0:r0 + rows], (0, pad)))


def _slab_possible(o, rd, box, best_t):
    """(rows,) bool: can a ray reach the tile's AABB ``box`` (lo xyz, hi xyz)
    closer than its running best?  The culled kernel's gate, per ray."""
    tnear = torch.full_like(best_t, -BIG)
    tfar = torch.full_like(best_t, BIG)
    for c in range(3):
        t0 = (box[c] - o[:, c]) * rd[:, c]
        t1 = (box[3 + c] - o[:, c]) * rd[:, c]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    return (tnear <= tfar) & (tfar > 0.0) & (tnear < best_t)


def _scan_plain(origin, direction, exclude, tris: MtTriangles, gated: bool):
    """Both plain versions: every block of RB rays walks the triangle tiles
    in ascending order; with ``gated`` a tile's arithmetic runs only if the
    slab test passes for any ray of the block (the gate reads the running
    best after all earlier tiles)."""
    R = origin.shape[0]
    device = origin.device
    t_out = torch.empty(R, dtype=torch.float32, device=device)
    i_out = torch.empty(R, dtype=torch.int32, device=device)
    for r0, rows, o, d, ex in _ray_blocks(origin, direction, exclude):
        if gated:
            tiny = torch.where(d >= 0, 1e-20, -1e-20).to(d.dtype)
            rd = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
        best_t = torch.full((RB,), BIG, dtype=torch.float32, device=device)
        best_i = torch.zeros(RB, dtype=torch.int32, device=device)
        for ti, base in enumerate(range(0, tris.packed.shape[1], TB)):
            if not gated or bool(_slab_possible(
                    o, rd, tris.tile_boxes[ti], best_t).any()):
                best_t, best_i = _mt_tile(
                    o, d, ex, tris.packed[:, base:base + TB], base, tris.num,
                    best_t, best_i)
        t_out[r0:r0 + rows] = best_t[:rows]
        i_out[r0:r0 + rows] = best_i[:rows]
    return t_out, i_out


def b3_shares(num: int, clusters: int = B3_CLUSTER):
    """The contiguous triangle ranges [lo, hi) that B3's CTAs scan, one a
    CTA of a cluster: a balanced split of the ``num`` real triangles (some
    empty when ``num`` < ``clusters``)."""
    return [(num * c // clusters, num * (c + 1) // clusters)
            for c in range(clusters)]


def _closest_plain(origin, direction, exclude, tris: MtTriangles):
    """The plain torch version of the all-pairs kernel: (t (R,) float32 with
    BIG on a miss, triangle id (R,) int32 in the order of ``packed``, 0 on a
    miss)."""
    return _scan_plain(origin, direction, exclude, tris, gated=False)


def _closest_culled_plain(origin, direction, exclude, tris: MtTriangles):
    """The plain torch version of the culled kernel, the gate taken per RB
    consecutive rays."""
    return _scan_plain(origin, direction, exclude, tris, gated=True)


# ---------------------------------------------------------------------------
# launching

def _check(name: str, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"mt_closest: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def mt_closest(origin, direction, exclude, tris: MtTriangles):
    """For each ray the closest Möller–Trumbore hit over ``tris.packed``:
    (t (R,) float32, BIG on a miss; id (R,) int32 in the order of
    ``packed``, 0 on a miss).

    ``origin``/``direction``: (R, 3) float32; ``exclude``: (R,) int32 id (in
    the order of ``packed``) that a ray must not hit, -1 for none.  With
    culled ``tris`` the rays are expected sorted by ``_ray_sort_keys`` (the
    gate is per RB consecutive rays; any order gives a valid closest hit).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``mt_closest.launches`` or ``mt_closest.culled_launches``)
    or raise.  The kernels have no adjoint: an input that requires grad
    raises.
    """
    if torch.is_grad_enabled() and (origin.requires_grad
                                    or direction.requires_grad
                                    or tris.packed.requires_grad):
        raise ValueError("mt_closest: ray–triangle intersection has no "
                         "gradient; detach the rays and the triangles")
    plain = _closest_culled_plain if tris.culled else _closest_plain
    if not origin.is_cuda:
        if origin.device.type != "cpu":
            raise ValueError(f"mt_closest: no kernel for device "
                             f"{origin.device}")
        return plain(origin, direction, exclude, tris)

    device = origin.device
    R = origin.shape[0]
    Tpad = tris.packed.shape[1]
    if R == 0 or Tpad == 0 or Tpad % TB:
        raise ValueError(f"mt_closest: {R} rays on {Tpad} packed triangles "
                         "is outside what the kernels cover")
    _check("origin", origin, (R, 3), torch.float32, device)
    _check("direction", direction, (R, 3), torch.float32, device)
    _check("exclude", exclude, (R,), torch.int32, device)
    _check("packed", tris.packed, (9, Tpad), torch.float32, device)
    t = torch.empty(R, dtype=torch.float32, device=device)
    idx = torch.empty(R, dtype=torch.int32, device=device)
    tensors = [origin, direction, exclude, tris.packed]
    if tris.culled:
        _check("tile_boxes", tris.tile_boxes, (Tpad // TB, 8), torch.float32,
               device)
        tensors.append(tris.tile_boxes)
        name, entry = "ray_mt_closest_culled", "wv_ray_mt_closest_culled_f32"
    else:
        name, entry = "ray_mt_closest", "wv_ray_mt_closest_f32"
    lib = load_entry(name, entry, len(tensors) + 2)
    err = getattr(lib, entry)(
        *(x.data_ptr() for x in tensors), t.data_ptr(), idx.data_ptr(), R,
        Tpad, tris.num, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    if tris.culled:
        mt_closest.culled_launches += 1
    else:
        mt_closest.launches += 1
    return t, idx


mt_closest.launches = 0
mt_closest.culled_launches = 0


def _occupancy(name: str, device) -> dict:
    lib = load(name)
    fn = getattr(lib, f"wv_{name}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        err = fn(*(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "clusters"),
                    (x.value for x in out)))


def closest_occupancy(device="cuda") -> dict:
    """What the card makes of the all-pairs kernel: registers a thread,
    local memory (spills) a thread in bytes, CTAs resident on one SM,
    clusters of ``B3_CLUSTER`` CTAs resident on the card."""
    return _occupancy("ray_mt_closest", device)


def culled_occupancy(device="cuda") -> dict:
    """What the card makes of the culled kernel: registers a thread, local
    memory (spills) a thread in bytes, CTAs resident on one SM, clusters of
    ``CLUSTER`` CTAs resident on the card."""
    return _occupancy("ray_mt_closest_culled", device)


# ---------------------------------------------------------------------------
# the queries

def _ray_sort_keys(origin, direction, tris: MtTriangles):
    """Spatial+directional sort key: 3-bit direction octant above a 15-bit
    (5/axis) origin Morton code — rays in one RB tile then share an origin
    blob and an octant, which is what makes the culled kernel's per-tile
    AABB gate actually skip."""
    rel = (origin - tris.scene_lo[None, :]) * tris.scene_inv_ext[None, :] \
        * 31.0
    # a dead ray's origin may be NaN: its key is that of 0 on any device
    q = torch.clamp(torch.nan_to_num(rel, nan=0.0), 0.0, 31.0) \
        .to(torch.int32)

    def spread5(x):
        x = (x | (x << 8)) & 0x0100F
        x = (x | (x << 4)) & 0x010C3
        x = (x | (x << 2)) & 0x09249
        return x

    morton = spread5(q[:, 0]) | (spread5(q[:, 1]) << 1) \
        | (spread5(q[:, 2]) << 2)
    octant = ((direction[:, 0] >= 0).to(torch.int32)
              | ((direction[:, 1] >= 0).to(torch.int32) << 1)
              | ((direction[:, 2] >= 0).to(torch.int32) << 2))
    return (octant << 15) | morton


def _kernel_rays(origin, direction, exclude_triangle, tris: MtTriangles):
    """The rays as ``mt_closest`` takes them: contiguous, the excludes int32
    and, for culled ``tris``, mapped to Morton-sorted triangle ids, with the
    rays sorted for the gate.  Returns (origin, direction, exclude, order);
    ``order`` (None unless culled) holds each sorted ray's original row."""
    if exclude_triangle is None:
        exclude_triangle = torch.full((origin.shape[0],), -1,
                                      dtype=torch.int32,
                                      device=origin.device)
    exclude_triangle = exclude_triangle.to(torch.int32)
    if not tris.culled:
        return (origin.contiguous(), direction.contiguous(),
                exclude_triangle.contiguous(), None)
    exclude_triangle = torch.where(
        exclude_triangle >= 0,
        tris.inv_perm[torch.clamp(exclude_triangle, 0, tris.num - 1).long()],
        torch.full_like(exclude_triangle, -1))
    order = torch.argsort(_ray_sort_keys(origin, direction, tris),
                          stable=True)
    return origin[order], direction[order], exclude_triangle[order], order


def mt_intersection(origin, direction, tris: MtTriangles,
                    exclude_triangle=None):
    """Closest hit; same contract as ``geometry.scene_intersection``:
    (t (R,) float32, inf on a miss; triangle id (R,) int32 in the soup's
    order; hit (R,) bool).  ``tris`` must lie on the rays' device.  Exclude
    and result ids are the soup's; culled kernels work in sorted ids."""
    o, d, ex, order = _kernel_rays(origin, direction, exclude_triangle, tris)
    t, idx = mt_closest(o, d, ex, tris)
    if order is not None:
        t = torch.empty_like(t).index_copy_(0, order, t)
        idx = torch.empty_like(idx).index_copy_(0, order, idx)
        idx = tris.perm[torch.clamp(idx, 0, tris.perm.shape[0] - 1).long()]
    hit = t < BIG
    return torch.where(hit, t, torch.full_like(t, float("inf"))), idx, hit


def mt_line_of_sight(start, end, tris: MtTriangles, exclude_triangle=None):
    """(R,) bool: segment start→end unobstructed."""
    seg = end - start
    dist = norm3(seg)
    direction = seg / torch.clamp(dist[:, None], min=1e-20)
    t, _, any_hit = mt_intersection(start, direction, tris,
                                    exclude_triangle=exclude_triangle)
    return (~any_hit) | (t >= dist * (1.0 - 1e-4))
