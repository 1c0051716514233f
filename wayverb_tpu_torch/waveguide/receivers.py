"""Receiver postprocessors: per-step taps on the pressure field.

Port of ``wayverb_tpu.waveguide.receivers``.  The tap index tensors are
built on the device once, at construction; each step is one gather.
``InterpolatedReceiver`` taps at a continuous position and differentiates
with respect to it.

Parity: reference ``waveguide/postprocessor/node.h`` (single-node pressure)
and ``postprocessor/directional_receiver.cpp:29-69`` (6-neighbour pressure
gradient → discrete velocity integrator → instantaneous intensity vector).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from wayverb_tpu_torch.waveguide.descriptor import (DIRECTION_OFFSETS,
                                                    MeshDescriptor)


@dataclasses.dataclass(frozen=True)
class NodeReceiver:
    node_idx: torch.Tensor     # () int64 flat index, on the field's device

    def init_state(self, dtype, device):
        return ()

    @functools.cached_property
    def _tap_idx(self) -> torch.Tensor:
        return self.node_idx.reshape(1)

    def tap_nodes(self) -> torch.Tensor:
        """Flat indices this receiver reads, in ``tap`` read order (the mega
        chunk extracts exactly these per step)."""
        return self._tap_idx

    def tap(self, field_flat, state):
        # a 1-D index gathers a copy; a 0-d index would return a view into
        # the field buffer, which the time loop overwrites two steps later
        return state, field_flat[self._tap_idx][0]


@dataclasses.dataclass(frozen=True)
class MultiNodeReceiver:
    """Pressure taps at several nodes at once (one gather serves them all)."""

    node_idx: torch.Tensor     # (N,) int64 flat indices

    def init_state(self, dtype, device):
        return ()

    def tap_nodes(self) -> torch.Tensor:
        return self.node_idx.reshape(-1)

    def tap(self, field_flat, state):
        return state, field_flat[self.node_idx.reshape(-1)]


@dataclasses.dataclass(frozen=True)
class DirectionalReceiver:
    """Velocity-integrating intensity probe at one mesh node.

    ``spacing`` and ``inv_density_dt`` are float32-rounded, as the
    reference's float32 scalars are.
    """

    node_idx: torch.Tensor       # () int64 flat index
    neighbor_idx: torch.Tensor   # (6,) int64 flat indices
    spacing: float               # mesh spacing
    inv_density_dt: float        # 1/(ambient_density · sample_rate)

    def init_state(self, dtype, device):
        return torch.zeros(3, dtype=dtype, device=device)

    @functools.cached_property
    def _tap_idx(self) -> torch.Tensor:
        return torch.cat([self.node_idx.reshape(1),
                          self.neighbor_idx.reshape(-1)])

    def tap_nodes(self) -> torch.Tensor:
        return self._tap_idx

    def tap(self, field_flat, velocity):
        """Returns (new_velocity, (intensity (3,), pressure ()))."""
        vals = field_flat[self._tap_idx]               # node, then 6 ports
        p = vals[0]
        surrounding = (vals[1:] - p) / self.spacing
        gradient = 0.5 * (surrounding[1::2] - surrounding[0::2])
        velocity = velocity - gradient * self.inv_density_dt
        intensity = velocity * p
        return velocity, (intensity, p)


_CORNER_BITS = tuple(tuple((c >> a) & 1 for a in range(3)) for c in range(8))


@dataclasses.dataclass(frozen=True)
class InterpolatedReceiver:
    """Trilinear pressure tap at a CONTINUOUS position, differentiable with
    respect to ``position``.

    The 8-corner cell is fixed at construction (the cell containing the
    nominal position); within it the interpolation, and its position
    gradient, is exact.
    """

    corner_idx: torch.Tensor      # (8,) int64 flat indices (corner c has
    #                               bit a of c set where it is +1 on axis a)
    base_position: torch.Tensor   # (3,) position of corner 0
    position: torch.Tensor        # (3,) continuous tap position
    spacing: float

    def init_state(self, dtype, device):
        return ()

    def tap_nodes(self) -> torch.Tensor:
        return self.corner_idx.reshape(-1)

    def tap(self, field_flat, state):
        vals = field_flat[self.corner_idx]               # (8,)
        f = torch.clamp((self.position - self.base_position) / self.spacing,
                        0.0, 1.0)                        # (3,)
        bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=f.device)
        w = torch.prod(torch.where(bits, f[None, :], 1.0 - f[None, :]),
                       dim=-1)
        return state, torch.sum(w.to(vals.dtype) * vals)


def make_interpolated_receiver(desc: MeshDescriptor, position, device
                               ) -> InterpolatedReceiver:
    loc = desc.locator(position)
    base = np.asarray(desc.position(loc))
    if np.any(base > np.asarray(position)):
        loc = loc - (base > np.asarray(position)).astype(loc.dtype)
        base = np.asarray(desc.position(loc))
    dims = np.asarray(desc.dimensions)
    corners = np.stack([loc + np.asarray(bits) for bits in _CORNER_BITS])
    if np.any(corners < 0) or np.any(corners >= dims):
        raise RuntimeError("interpolation cell leaves the mesh")
    flat = np.ravel_multi_index(
        (corners[:, 0], corners[:, 1], corners[:, 2]),
        desc.dimensions).astype(np.int64)
    return InterpolatedReceiver(
        corner_idx=torch.as_tensor(flat, device=device),
        base_position=torch.as_tensor(base.astype(np.float32), device=device),
        position=torch.as_tensor(np.asarray(position, dtype=np.float32),
                                 device=device),
        spacing=float(np.float32(desc.spacing)))


def make_directional_receiver(desc: MeshDescriptor, sample_rate: float,
                              ambient_density: float, position, device
                              ) -> DirectionalReceiver:
    loc = desc.locator(position)
    dims = np.asarray(desc.dimensions)
    neighbors = loc[None, :] + DIRECTION_OFFSETS
    if np.any(neighbors < 0) or np.any(neighbors >= dims):
        raise RuntimeError(
            "can't place directional receiver adjacent to the mesh edge")
    flat = lambda l: np.ravel_multi_index(            # noqa: E731
        (l[..., 0], l[..., 1], l[..., 2]), desc.dimensions).astype(np.int64)
    return DirectionalReceiver(
        node_idx=torch.as_tensor(flat(loc), device=device),
        neighbor_idx=torch.as_tensor(flat(neighbors), device=device),
        spacing=float(np.float32(desc.spacing)),
        inv_density_dt=float(np.float32(1.0 / (ambient_density
                                                * sample_rate))),
    )
