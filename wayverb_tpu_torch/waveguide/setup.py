"""Mesh setup: node classification + boundary structure.

Port of ``wayverb_tpu.waveguide.setup`` for the shoebox path: the analytic
inside test, the boundary classification, the surface assignment and the
structure assembly.  The general scene classification
(``classify_inside_scene``) waits for the arbitrary-geometry slice.

The box path reads only ``coef_b``, ``coef_a`` and ``filter_order``, so
only the coefficient tables are device tensors.  The compact general-path
tables stay host numpy (``None`` when a mesh is built without them, as
``convert.mesh_from_numpy`` does) until the general slice needs them.

Node taxonomy (parity: reference ``mesh_setup_program.cpp``): inside,
reentrant, 1D/2D/3D boundary, outside.  Surface assignment (parity:
``boundary_coefficient_program.cpp``): 1D nodes take the surface of the
closest triangle; 2D/3D nodes inherit from adjacent 1D nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from wayverb_tpu_torch.core.geometry import TriangleSoup
from wayverb_tpu_torch.waveguide.descriptor import (DIRECTION_OFFSETS,
                                                    MeshDescriptor)

# 12 two-axis diagonal direction combos and 8 corner combos, expressed as
# pairs/triples of port indices (same priority order as the reference's
# directions_2d / directions_3d tables)
_DIRS_2D = [(0, 2), (0, 3), (1, 2), (1, 3), (0, 4), (0, 5), (1, 4), (1, 5),
            (2, 4), (2, 5), (3, 4), (3, 5)]
_DIRS_3D = [(0, 2, 4), (0, 2, 5), (0, 3, 4), (0, 3, 5),
            (1, 2, 4), (1, 2, 5), (1, 3, 4), (1, 3, 5)]

_AXIS_OF_DIR = np.asarray([0, 0, 1, 1, 2, 2])


@dataclasses.dataclass(frozen=True)
class MeshStructure:
    """Boundary filter tables (device) + the general-path tables (host).

    ``coef_b``/``coef_a``: (S, order+1) per-surface impedance filters, the
    system's learnable parameters, as device tensors.  The remaining fields
    are the reference's compact boundary arrays, kept as host numpy.
    """

    coef_b: torch.Tensor            # (S, order+1) impedance numerators
    coef_a: torch.Tensor            # (S, order+1) impedance denominators
    interior_mask: Optional[np.ndarray] = None     # (X,Y,Z) f32
    b_node_idx: Optional[np.ndarray] = None        # (B,) int32
    b_neighbor_idx: Optional[np.ndarray] = None    # (B,6) int32
    b_neighbor_w: Optional[np.ndarray] = None      # (B,6) f32 2/1/0
    b_slot_mask: Optional[np.ndarray] = None       # (B,3) f32
    b_slot_inner_idx: Optional[np.ndarray] = None  # (B,3) int32
    b_slot_coef: Optional[np.ndarray] = None       # (B,3) int32
    weight_code: Optional[np.ndarray] = None       # (X,Y,Z) int32

    @property
    def filter_order(self) -> int:
        return self.coef_b.shape[1] - 1


# ---------------------------------------------------------------------------
# classification

def classify_inside_shoebox(desc: MeshDescriptor, box) -> np.ndarray:
    """Analytic inside test for an axis-aligned box (fast path)."""
    pos = desc.node_positions()
    lo = np.asarray(box.min_corner)
    hi = np.asarray(box.max_corner)
    return np.all((pos > lo) & (pos < hi), axis=-1)


def _shift_inside(inside: np.ndarray, offset) -> np.ndarray:
    """inside mask shifted so [i] = inside[i + offset] (False outside)."""
    out = np.zeros_like(inside)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    for ax, o in enumerate(offset):
        n = inside.shape[ax]
        if o == 1:
            dst[ax], src[ax] = slice(0, n - 1), slice(1, n)
        elif o == -1:
            dst[ax], src[ax] = slice(1, n), slice(0, n - 1)
    out[tuple(dst)] = inside[tuple(src)]
    return out


def classify_boundaries(inside: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node boundary category.

    Returns (category, inner_dirs):
      category: (X,Y,Z) int8 — 0 outside, 1 interior-update (inside or
                reentrant), 2/3/4 → 1D/2D/3D boundary
      inner_dirs: (X,Y,Z,3) int8 — port indices of inner directions
                (−1 padding)
    """
    shp = inside.shape
    neigh = np.stack([_shift_inside(inside, off)
                      for off in DIRECTION_OFFSETS], axis=-1)   # (X,Y,Z,6)

    category = np.zeros(shp, dtype=np.int8)
    inner = np.full(shp + (3,), -1, dtype=np.int8)
    category[inside] = 1

    outside = ~inside
    cnt1 = neigh.sum(axis=-1)

    # 1D: exactly one inside axis-neighbour
    is_1d = outside & (cnt1 == 1)
    category[is_1d] = 2
    inner[is_1d, 0] = np.argmax(neigh[is_1d], axis=-1)

    # reentrant: more than one inside axis-neighbour
    is_reent = outside & (cnt1 > 1)
    category[is_reent] = 1

    # 2D: no axis-neighbour inside, exactly one diagonal pair inside
    undecided = outside & (cnt1 == 0)
    diag2 = np.stack([_shift_inside(
        inside, DIRECTION_OFFSETS[i] + DIRECTION_OFFSETS[j])
        for i, j in _DIRS_2D], axis=-1)                        # (X,Y,Z,12)
    cnt2 = diag2.sum(axis=-1)
    is_2d = undecided & (cnt2 == 1)
    sel2 = np.argmax(diag2[is_2d], axis=-1)
    pairs = np.asarray(_DIRS_2D, dtype=np.int8)
    category[is_2d] = 3
    inner[is_2d, 0] = pairs[sel2, 0]
    inner[is_2d, 1] = pairs[sel2, 1]
    category[undecided & (cnt2 > 1)] = 1                       # reentrant

    # 3D: otherwise, exactly one corner inside
    undecided = undecided & (cnt2 == 0)
    diag3 = np.stack([_shift_inside(
        inside,
        DIRECTION_OFFSETS[i] + DIRECTION_OFFSETS[j] + DIRECTION_OFFSETS[k])
        for i, j, k in _DIRS_3D], axis=-1)                     # (X,Y,Z,8)
    cnt3 = diag3.sum(axis=-1)
    is_3d = undecided & (cnt3 == 1)
    sel3 = np.argmax(diag3[is_3d], axis=-1)
    triples = np.asarray(_DIRS_3D, dtype=np.int8)
    category[is_3d] = 4
    inner[is_3d, 0] = triples[sel3, 0]
    inner[is_3d, 1] = triples[sel3, 1]
    inner[is_3d, 2] = triples[sel3, 2]
    category[undecided & (cnt3 > 1)] = 1                       # reentrant

    return category, inner


# ---------------------------------------------------------------------------
# surface assignment

def _closest_triangle_surface(points: np.ndarray, soup: TriangleSoup,
                              chunk: int = 8192) -> np.ndarray:
    """Surface index of the triangle closest to each point (B, 3)."""
    from wayverb_tpu_torch.utils import native
    native_result = native.closest_triangle_surface(
        points, np.asarray(soup.vertices), np.asarray(soup.triangles),
        np.asarray(soup.surfaces))
    if native_result is not None:
        return native_result

    corners = np.asarray(soup.corners())          # (T, 3, 3)
    surf = np.asarray(soup.surfaces)
    out = np.zeros(points.shape[0], dtype=np.int32)
    for i in range(0, points.shape[0], chunk):
        p = points[i:i + chunk]
        d = _point_triangle_distance_sq(p[:, None, :], corners[None])
        out[i:i + chunk] = surf[np.argmin(d, axis=-1)]
    return out


def _point_triangle_distance_sq(p, tri):
    """Squared distance point→triangle, vectorized (numpy, setup-time)."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0.0, 1.0)
    w = np.clip(vc / denom, 0.0, 1.0)

    # interior projection
    closest = a + v[..., None] * ab + w[..., None] * ac

    # edge/vertex regions
    t_ab = np.clip(d1 / np.maximum(d1 - d3, 1e-30), 0.0, 1.0)
    t_ac = np.clip(d2 / np.maximum(d2 - d6, 1e-30), 0.0, 1.0)
    t_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-30),
                   0.0, 1.0)

    cand = np.stack([
        a + 0 * closest,                                   # vertex a
        b + 0 * closest,
        c + 0 * closest,
        a + t_ab[..., None] * ab,                          # edge ab
        a + t_ac[..., None] * ac,                          # edge ac
        b + t_bc[..., None] * (c - b),                     # edge bc
        closest,
    ], axis=0)
    inside_face = (vb >= 0) & (vc >= 0) & (va >= 0)
    d_all = np.sum((cand - p[None]) ** 2, axis=-1)
    d_face = np.where(inside_face, d_all[-1], np.inf)
    return np.minimum(d_all[:-1].min(axis=0), d_face)


# ---------------------------------------------------------------------------
# assembly

def build_structure(desc: MeshDescriptor, inside: np.ndarray,
                    soup: TriangleSoup, coef_b: np.ndarray,
                    coef_a: np.ndarray, device) -> MeshStructure:
    """Assemble the MeshStructure from an inside mask + surfaces.

    ``coef_b``/``coef_a``: (S, order+1) per-surface impedance filters; they
    go to ``device``, everything else stays on the host.
    """
    dims = desc.dimensions
    category, inner = classify_boundaries(inside)

    is_boundary = category >= 2
    b_loc = np.argwhere(is_boundary)                       # (B, 3)
    b_cnt = (category[is_boundary] - 1).astype(np.int32)   # 1, 2, 3
    b_inner = inner[is_boundary]                           # (B, 3)

    def flat(loc):
        """C-order flat index, matching ``field.reshape(-1)``.

        Out-of-range coordinates clip; callers mask those lanes to weight 0.
        """
        return np.ravel_multi_index(
            (loc[..., 0], loc[..., 1], loc[..., 2]), dims,
            mode="clip").astype(np.int32)

    b_node_idx = flat(b_loc)

    # neighbour indices + weights
    neigh_loc = b_loc[:, None, :] + DIRECTION_OFFSETS[None]      # (B,6,3)
    in_bounds = np.all((neigh_loc >= 0) & (neigh_loc < np.asarray(dims)),
                       axis=-1)
    neigh_idx = np.where(in_bounds, flat(neigh_loc), 0).astype(np.int32)

    w = np.zeros((b_loc.shape[0], 6), dtype=np.float32)
    inner_axis_used = np.zeros((b_loc.shape[0], 3), dtype=bool)
    for s in range(3):
        d = b_inner[:, s]
        active = d >= 0
        w[np.arange(w.shape[0])[active], d[active]] = 2.0
        ax = _AXIS_OF_DIR[np.clip(d, 0, 5)]
        inner_axis_used[np.arange(w.shape[0])[active], ax[active]] = True
    for dir_i in range(6):
        ax = _AXIS_OF_DIR[dir_i]
        surrounding = (w[:, dir_i] == 0) & ~inner_axis_used[:, ax]
        w[surrounding, dir_i] = 1.0
    w = w * in_bounds  # never read out-of-mesh

    # slots
    slot_mask = (b_inner >= 0).astype(np.float32)
    slot_dir = np.clip(b_inner, 0, 5).astype(np.int64)
    slot_off = DIRECTION_OFFSETS[slot_dir]                       # (B,3,3)
    slot_loc = b_loc[:, None, :] + slot_off
    slot_ok = np.all((slot_loc >= 0) & (slot_loc < np.asarray(dims)),
                     axis=-1)
    slot_inner_idx = np.where(slot_ok, flat(slot_loc), 0).astype(np.int32)
    slot_mask = slot_mask * slot_ok

    # surface assignment (reference boundary_coefficient_program.cpp):
    # 1D (face) nodes take the closest triangle's surface (:243-308); 2D
    # edge nodes inherit each slot's surface from the adjacent 1D node of
    # the corresponding wall (step along the OTHER inner direction, :360);
    # 3D corner nodes step along the other TWO (:430).  Nodes whose
    # inheritance target is missing (degenerate geometry) fall back to
    # their own closest triangle.
    positions = desc.node_positions()[is_boundary]
    surf_idx = _closest_triangle_surface(positions, soup)
    slot_coef = np.tile(surf_idx[:, None], (1, 3)).astype(np.int32)

    row_map = np.full(dims, -1, dtype=np.int64)
    row_map[b_loc[:, 0], b_loc[:, 1], b_loc[:, 2]] = \
        np.arange(b_loc.shape[0])

    def inherit(rows, step_slots):
        """slot s of ``rows`` ← 1D neighbour reached by stepping along the
        offsets of the OTHER inner-direction slots in ``step_slots``."""
        for s in range(3):
            others = [o for o in range(3) if o != s and o in step_slots]
            if s not in step_slots:
                continue
            step = np.zeros((len(rows), 3), dtype=np.int64)
            for o in others:
                step += DIRECTION_OFFSETS[
                    np.clip(b_inner[rows, o], 0, 5)]
            tgt = b_loc[rows] + step
            okr = np.all((tgt >= 0) & (tgt < np.asarray(dims)), axis=-1)
            trow = np.where(okr, row_map[np.clip(tgt[:, 0], 0, dims[0] - 1),
                                         np.clip(tgt[:, 1], 0, dims[1] - 1),
                                         np.clip(tgt[:, 2], 0, dims[2] - 1)],
                            -1)
            good = (trow >= 0) & (b_cnt[np.maximum(trow, 0)] == 1)
            slot_coef[rows[good], s] = surf_idx[trow[good]]

    rows2 = np.nonzero(b_cnt == 2)[0]
    if len(rows2):
        inherit(rows2, step_slots=(0, 1))
    rows3 = np.nonzero(b_cnt == 3)[0]
    if len(rows3):
        inherit(rows3, step_slots=(0, 1, 2))

    interior_mask = (category == 1).astype(np.float32)

    # packed weight bitfield: interior / reentrant nodes take the six unit
    # weights plus the subtract-previous bit; boundary nodes encode their
    # {0, 1, 2} neighbour weights; outside nodes stay 0
    INTERIOR_CODE = 0x103F
    weight_code = np.where(category == 1, INTERIOR_CODE, 0).astype(np.int32)
    b_bits = ((w >= 1.0).astype(np.int32) << np.arange(6)).sum(axis=-1) \
        | ((w == 2.0).astype(np.int32) << (6 + np.arange(6))).sum(axis=-1)
    wc_flat = weight_code.reshape(-1)
    wc_flat[b_node_idx] = b_bits
    weight_code = wc_flat.reshape(dims)

    return MeshStructure(
        coef_b=torch.tensor(np.asarray(coef_b), dtype=torch.float32,
                            device=device),
        coef_a=torch.tensor(np.asarray(coef_a), dtype=torch.float32,
                            device=device),
        interior_mask=interior_mask,
        b_node_idx=b_node_idx,
        b_neighbor_idx=neigh_idx,
        b_neighbor_w=w.astype(np.float32),
        b_slot_mask=slot_mask.astype(np.float32),
        b_slot_inner_idx=slot_inner_idx,
        b_slot_coef=slot_coef,
        weight_code=weight_code,
    )


def estimate_volume(desc: MeshDescriptor, inside: np.ndarray) -> float:
    """Inside-node count × cell volume (reference mesh.cpp:40-49)."""
    return float(inside.sum()) * desc.spacing ** 3
