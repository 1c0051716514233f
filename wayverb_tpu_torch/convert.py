"""Carry a scene's state across from the reference package as numpy arrays.

``mesh_from_numpy`` builds the port's ``Mesh`` (shoebox, thin box or general
scene) from the fields of a reference mesh, so both packages can run on
exactly the same coefficient and boundary tables (the fitted boundary
filters are the system's learnable parameters).
``soup_from_numpy`` and ``surface_from_numpy`` do the same for a scene's
triangles and materials, ``ray_grid_from_numpy`` and
``mt_triangles_from_numpy`` for the ray acceleration tables, and
``waveguide_state_from_numpy`` for a chunked run's solver state.  The caller
extracts the arrays; this package never imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from wayverb_tpu_torch.core.geometry import TriangleSoup
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.raytracer.accel import RayGrid
from wayverb_tpu_torch.raytracer.mt_kernels import MtTriangles
from wayverb_tpu_torch.waveguide.box_boundary import Region
from wayverb_tpu_torch.waveguide.box_fused import BoxSpec
from wayverb_tpu_torch.waveguide.checkpoint import (WaveguideState,
                                                    _state_from_leaves)
from wayverb_tpu_torch.waveguide.descriptor import MeshDescriptor
from wayverb_tpu_torch.waveguide.run import Mesh
from wayverb_tpu_torch.waveguide.setup import (GENERAL_TABLE_DTYPES,
                                               structure_from_numpy)


def mesh_from_numpy(d: dict, device) -> Mesh:
    """Build a ``Mesh`` on ``device`` from numpy arrays.

    Keys: ``min_corner`` (3,), ``dimensions`` (3,), ``spacing`` (), the
    ``inside`` mask (X, Y, Z), ``coef_b``/``coef_a`` (S, order+1) and
    ``room_volume`` ().  Optional: the box spec's ``box_dims``, ``box_ilo``,
    ``box_ihi`` (3,) and ``box_face_surface`` (6,) for a shoebox; the
    general-path tables of the structure under their field names
    (``interior_mask``, ``b_node_idx``, ``b_neighbor_idx``,
    ``b_neighbor_w``, ``b_slot_mask``, ``b_slot_inner_idx``,
    ``b_slot_coef``, ``weight_code``), all or none; and ``regions``, a
    sequence of (start, size, inner_dirs, slot_coefs) tuples.  A mesh
    without the box spec routes to the region path when it has regions and
    to the general path otherwise; without the general-path tables it
    serves the box path only.
    """
    ints = lambda v: tuple(int(x) for x in np.asarray(v))  # noqa: E731
    desc = MeshDescriptor(
        min_corner=tuple(float(v) for v in np.asarray(d["min_corner"])),
        dimensions=ints(d["dimensions"]), spacing=float(d["spacing"]))
    present = [k for k in GENERAL_TABLE_DTYPES if k in d]
    if present and len(present) != len(GENERAL_TABLE_DTYPES):
        raise ValueError("general-path tables must come all or none; got "
                         f"only {present}")
    structure = structure_from_numpy(d["coef_b"], d["coef_a"],
                                     {k: d[k] for k in present}, device)
    spec = None
    if "box_dims" in d:
        spec = BoxSpec(dims=ints(d["box_dims"]), ilo=ints(d["box_ilo"]),
                       ihi=ints(d["box_ihi"]),
                       face_surface=ints(d["box_face_surface"]))
    regions = None
    if d.get("regions") is not None:
        regions = [Region(*(ints(part) for part in r)) for r in d["regions"]]
    return Mesh(descriptor=desc, structure=structure,
                inside=np.asarray(d["inside"], dtype=bool),
                room_volume=float(d["room_volume"]), regions=regions,
                box_spec=spec)


def soup_from_numpy(vertices, triangles, surfaces, device="cpu"
                    ) -> TriangleSoup:
    """A ``TriangleSoup`` from (V, 3) vertices, (T, 3) vertex indices and
    (T,) material indices."""
    return TriangleSoup(
        vertices=torch.tensor(np.asarray(vertices), dtype=torch.float32,
                              device=device),
        triangles=torch.tensor(np.asarray(triangles), dtype=torch.int32,
                               device=device),
        surfaces=torch.tensor(np.asarray(surfaces), dtype=torch.int32,
                              device=device))


def surface_from_numpy(absorption, scattering, device="cpu") -> Surface:
    """A ``Surface`` table from (..., bands) absorption and scattering."""
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,  # noqa
                                 device=device)
    return Surface(absorption=f32(absorption), scattering=f32(scattering))


def ray_grid_from_numpy(cells, lo, voxel, res, device="cpu") -> RayGrid:
    """A ``RayGrid`` from the fields of a reference grid: (C, K) int32
    ``cells``, (3,) float32 ``lo`` and ``voxel``, and the ``res`` triple."""
    as_t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt,  # noqa: E731
                                      device=device)
    return RayGrid(cells=as_t(cells, torch.int32), lo=as_t(lo, torch.float32),
                   voxel=as_t(voxel, torch.float32),
                   res=tuple(int(r) for r in res))


def mt_triangles_from_numpy(packed, num, tile_boxes=None, perm=None,
                            inv_perm=None, scene_lo=None, scene_inv_ext=None,
                            device="cpu") -> MtTriangles:
    """An ``MtTriangles`` from the fields of the reference's packed
    triangles; the five optional tables come all (culled) or none."""
    def as_t(x, dt):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dt,
                                                   device=device)
    return MtTriangles(
        packed=as_t(packed, torch.float32), num=int(num),
        tile_boxes=as_t(tile_boxes, torch.float32),
        perm=as_t(perm, torch.int32), inv_perm=as_t(inv_perm, torch.int32),
        scene_lo=as_t(scene_lo, torch.float32),
        scene_inv_ext=as_t(scene_inv_ext, torch.float32))


def waveguide_state_from_numpy(leaves, step: int, mesh: Mesh, receiver,
                               dtype=torch.float32, *, device
                               ) -> WaveguideState:
    """A ``checkpoint.WaveguideState`` on ``device`` from the reference
    state's leaves as numpy arrays, in the reference's order (its
    ``save_state`` order: fields, boundary state, receiver state, stable)
    and its ``step``; ``mesh`` and ``receiver`` give the structure."""
    return _state_from_leaves(leaves, step, mesh, receiver, dtype,
                              device=device)
