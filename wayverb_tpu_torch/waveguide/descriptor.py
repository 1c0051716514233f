"""Mesh descriptor: grid placement, index math, Courant relations.

Port of ``wayverb_tpu.waveguide.descriptor`` (pure numpy, as it stands).

Parity: reference ``waveguide/mesh_descriptor.h:14-55`` +
``mesh_descriptor.cpp`` (index = x + y·dx + z·dx·dy; position = min_corner +
locator·spacing), ``waveguide/config.cpp:15-25`` (Courant number 1/√3:
dt = Δx/(c√3), fs = c·√3/Δx), ``waveguide/simulation_parameters.h:60-73``
(fs = cutoff/(0.25·usable_portion)), ``waveguide/boundary_adjust.h``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from wayverb_tpu_torch.core.geometry import Box

COURANT = 1.0 / math.sqrt(3.0)
COURANT_SQ = 1.0 / 3.0

# six port directions, index order matches the reference PortDirection enum
# (nx, px, ny, py, nz, pz)
DIRECTION_OFFSETS = np.asarray([
    [-1, 0, 0], [1, 0, 0],
    [0, -1, 0], [0, 1, 0],
    [0, 0, -1], [0, 0, 1],
], dtype=np.int32)


def speed_of_sound_from(time_step: float, grid_spacing: float) -> float:
    return grid_spacing / (time_step * math.sqrt(3.0))


def time_step(speed_of_sound: float, grid_spacing: float) -> float:
    return grid_spacing / (speed_of_sound * math.sqrt(3.0))


def grid_spacing(speed_of_sound: float, time_step_: float) -> float:
    return speed_of_sound * time_step_ * math.sqrt(3.0)


def compute_sampling_frequency(cutoff: float, usable_portion: float) -> float:
    """Mesh rate for a target usable cutoff (simulation_parameters.h:60-73)."""
    return cutoff / (0.25 * usable_portion)


def compute_cutoff_frequency(sample_rate: float, usable_portion: float
                             ) -> float:
    return sample_rate * 0.25 * usable_portion


@dataclasses.dataclass(frozen=True)
class MeshDescriptor:
    min_corner: Tuple[float, float, float]
    dimensions: Tuple[int, int, int]      # nodes along x, y, z
    spacing: float

    @property
    def num_nodes(self) -> int:
        dx, dy, dz = self.dimensions
        return dx * dy * dz

    def sample_rate(self, speed_of_sound: float) -> float:
        return 1.0 / time_step(speed_of_sound, self.spacing)

    def position(self, locator) -> np.ndarray:
        return np.asarray(self.min_corner) + \
            np.asarray(locator) * self.spacing

    def locator(self, position) -> np.ndarray:
        rel = (np.asarray(position) - np.asarray(self.min_corner)) \
            / self.spacing
        return np.round(rel).astype(np.int64)

    def flat_index(self, locator) -> int:
        """C-order flat index (z fastest) — matches ``field.reshape(-1)``."""
        loc = np.asarray(locator)
        return int(np.ravel_multi_index(tuple(loc), self.dimensions))

    def node_positions(self) -> np.ndarray:
        """(X, Y, Z, 3) physical positions of all nodes."""
        dx, dy, dz = self.dimensions
        gx, gy, gz = np.meshgrid(np.arange(dx), np.arange(dy), np.arange(dz),
                                 indexing="ij")
        loc = np.stack([gx, gy, gz], axis=-1)
        return np.asarray(self.min_corner) + loc * self.spacing

    def aabb(self) -> Box:
        lo = np.asarray(self.min_corner)
        hi = lo + np.asarray(self.dimensions) * self.spacing
        return Box(tuple(lo), tuple(hi))


def compute_adjusted_boundary(scene_aabb: Box, anchor, spacing: float) -> Box:
    """Expand the scene AABB so that ``anchor`` lands exactly on a node.

    Parity: reference ``waveguide/boundary_adjust.cpp`` — grow each min
    corner outward to an integer number of spacings from the anchor, plus a
    padding ring.
    """
    anchor = np.asarray(anchor, dtype=np.float64)
    lo = np.asarray(scene_aabb.min_corner, dtype=np.float64)
    hi = np.asarray(scene_aabb.max_corner, dtype=np.float64)
    steps_lo = np.ceil((anchor - lo) / spacing) + 1
    new_lo = anchor - steps_lo * spacing
    steps = np.ceil((hi - new_lo) / spacing) + 1
    new_hi = new_lo + steps * spacing
    return Box(tuple(new_lo), tuple(new_hi))


def descriptor_for_box(box: Box, spacing: float,
                       align: Tuple[int, int, int] | None = None
                       ) -> MeshDescriptor:
    """``align`` rounds each dimension up to the given multiple (extra nodes
    are outside the scene and inert)."""
    lo = np.asarray(box.min_corner, dtype=np.float64)
    hi = np.asarray(box.max_corner, dtype=np.float64)
    # tolerant floor: (hi−lo)/spacing is an exact integer by construction of
    # compute_adjusted_boundary; float error must not drop the last (outside
    # margin) plane, which the fused box step's halo reads rely on
    dims = [int(d) for d in np.floor((hi - lo) / spacing * (1 + 1e-9)) + 1]
    if align is not None:
        dims = [-(-d // a) * a for d, a in zip(dims, align)]
    return MeshDescriptor(tuple(lo), tuple(dims), float(spacing))


def default_alignment() -> Tuple[int, int, int] | None:
    """Grid alignment the kernels need: none, the CUDA fused step takes any
    dims (the reference pads to TPU tiles on a TPU only)."""
    return None
