"""Impulse batches: the common currency between the geometric solvers and IR
assembly.

Port of ``wayverb_tpu.core.impulse``.  A batch is struct-of-arrays:
``volume`` (N, bands) per-band pressure/energy, ``position`` (N, 3),
``distance`` (N,) path length in metres.

Parity: reference ``raytracer/cl/structs.h`` (``impulse<8>``,
``attenuated_impulse``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Impulses:
    volume: torch.Tensor     # (N, bands)
    position: torch.Tensor   # (N, 3)
    distance: torch.Tensor   # (N,)

    @property
    def count(self) -> int:
        return self.volume.shape[0]

    def concatenate(self, other: "Impulses") -> "Impulses":
        return Impulses(torch.cat([self.volume, other.volume]),
                        torch.cat([self.position, other.position]),
                        torch.cat([self.distance, other.distance]))


def apply_distance_pressure(impulses: Impulses, acoustic_impedance):
    """Scale volumes by √(Z/4π)/d — spherical spreading in pressure terms.

    Parity: ``reflection_processor/image_source.cpp:61-65``.
    """
    scale = math.sqrt(acoustic_impedance / (4.0 * math.pi)) / \
        torch.clamp(impulses.distance, min=1e-8)
    return dataclasses.replace(impulses,
                               volume=impulses.volume * scale[:, None])
