"""Orientations and azimuth/elevation look-up-table binning.

Port of ``wayverb_tpu.core.orientation``.  ``random_unit_vectors`` draws
from a ``torch.Generator``: the reference's ``jax.random`` stream cannot be
reproduced in torch, so parity tests feed the reference's draws in instead.

Parity: reference ``core/orientation.h``, ``core/az_el.h``,
``core/vector_look_up_table.h``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


def sphere_point(z, theta):
    """Unit vector from height z ∈ [-1,1] and angle θ ∈ [-π,π] (y is the
    polar axis: (t cos θ, z, t sin θ) with t = √(1-z²))."""
    t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([t * torch.cos(theta), z, t * torch.sin(theta)],
                       dim=-1)


def random_unit_vectors(n: int, generator: Optional[torch.Generator],
                        device=None):
    """(n, 3) uniformly distributed unit vectors.

    The draws are made on the generator's device and moved to ``device``
    (default: the generator's), so generators of one seed give the same
    vectors on every device.  ``generator=None`` draws from torch's default
    generator of ``device``."""
    gdev = generator.device if generator is not None else device
    z = torch.rand(n, generator=generator, device=gdev) * 2.0 - 1.0
    theta = (torch.rand(n, generator=generator, device=gdev) * 2.0 - 1.0) \
        * math.pi
    return sphere_point(z, theta).to(device if device is not None else gdev)


def azimuth(v):
    """Azimuth angle of (..., 3) vectors: atan2(x, z)."""
    return torch.atan2(v[..., 0], v[..., 2])


def elevation(v):
    """Elevation angle of (..., 3) vectors: asin(y / |v|)."""
    n = torch.linalg.vector_norm(v, dim=-1)
    return torch.arcsin(torch.clamp(v[..., 1] / torch.clamp(n, min=1e-20),
                                    -1.0, 1.0))


def _normalized(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-20)


@dataclasses.dataclass(frozen=True)
class Orientation:
    """A pointing direction with an up vector — builds a rotation basis."""

    pointing: Any = (0.0, 0.0, 1.0)
    up: Any = (0.0, 1.0, 0.0)

    def matrix(self, device) -> torch.Tensor:
        """3x3 rotation: world → orientation-local coordinates."""
        z = _normalized(torch.tensor(self.pointing, dtype=torch.float32,
                                     device=device))
        up = torch.tensor(self.up, dtype=torch.float32, device=device)
        x = _normalized(torch.linalg.cross(up, z))
        y = torch.linalg.cross(z, x)
        return torch.stack([x, y, z], dim=0)

    def transform(self, v):
        """Rotate world vectors (..., 3) into the local frame."""
        return v @ self.matrix(v.device).T


def angle_lut_indices(v, num_az: int, num_el: int):
    """Bin directions (..., 3) into an az×el look-up table.

    Azimuth wraps over ``num_az`` equal bins; elevation spans (-π/2, π/2)
    over ``num_el`` bins, with the poles clamped into the extreme bins.
    """
    az = azimuth(v)
    el = elevation(v)
    az_bin = torch.remainder(torch.floor(
        (az / (2.0 * math.pi) + 1.0) * num_az + 0.5).to(torch.int32), num_az)
    el_span = math.pi / num_el
    el_bin = torch.clamp(
        torch.floor(el / el_span + 0.5).to(torch.int32) + num_el // 2,
        0, num_el - 1)
    return az_bin, el_bin
