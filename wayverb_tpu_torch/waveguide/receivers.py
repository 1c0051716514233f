"""Receiver postprocessors: per-step taps on the pressure field.

Port of ``NodeReceiver``, ``DirectionalReceiver`` and
``make_directional_receiver`` from ``wayverb_tpu.waveguide.receivers``.  The
tap index tensors are built on the device once, at construction; each step
is one gather.

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
