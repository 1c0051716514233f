"""Carry a mesh's state across from the reference package as numpy arrays.

``mesh_from_numpy`` builds the port's shoebox ``Mesh`` from the fields of a
reference mesh, so both packages can run on exactly the same coefficient
tables (the fitted boundary filters are the system's learnable parameters).
The caller extracts the arrays; this package never imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from wayverb_tpu_torch.waveguide.box_fused import BoxSpec
from wayverb_tpu_torch.waveguide.descriptor import MeshDescriptor
from wayverb_tpu_torch.waveguide.run import Mesh
from wayverb_tpu_torch.waveguide.setup import MeshStructure


def mesh_from_numpy(d: dict, device) -> Mesh:
    """Build a shoebox ``Mesh`` on ``device`` from numpy arrays.

    Keys: ``min_corner`` (3,), ``dimensions`` (3,), ``spacing`` (), the
    ``inside`` mask (X, Y, Z), ``coef_b``/``coef_a`` (S, order+1),
    ``room_volume`` (), and the box spec's ``box_dims``, ``box_ilo``,
    ``box_ihi`` (3,) and ``box_face_surface`` (6,).  The general-path
    tables of the structure are left out (the box path does not read them).
    """
    ints = lambda k: tuple(int(v) for v in np.asarray(d[k]))  # noqa: E731
    desc = MeshDescriptor(
        min_corner=tuple(float(v) for v in np.asarray(d["min_corner"])),
        dimensions=ints("dimensions"), spacing=float(d["spacing"]))
    structure = MeshStructure(
        coef_b=torch.tensor(np.asarray(d["coef_b"]), dtype=torch.float32,
                            device=device),
        coef_a=torch.tensor(np.asarray(d["coef_a"]), dtype=torch.float32,
                            device=device))
    spec = BoxSpec(dims=ints("box_dims"), ilo=ints("box_ilo"),
                   ihi=ints("box_ihi"), face_surface=ints("box_face_surface"))
    return Mesh(descriptor=desc, structure=structure,
                inside=np.asarray(d["inside"], dtype=bool),
                room_volume=float(d["room_volume"]), box_spec=spec)
