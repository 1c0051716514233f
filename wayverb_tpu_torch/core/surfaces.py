"""Surface acoustics: absorption / reflectance / impedance conversions.

Port of ``wayverb_tpu.core.surfaces``.  All functions are elementwise over
8-band tensors (``bands`` axis last).

Parity: reference ``core/surfaces.h:24-65`` (conversion chain) and
``core/cl/scene_structs.h:10-49`` (8-band surface, ``simulation_bands = 8``).
Energy bookkeeping per vorlander2007 p.45: reflected = 1-a, scattered =
s(1-a), specular = (1-s)(1-a).
"""

from __future__ import annotations

import dataclasses

import torch

SIMULATION_BANDS = 8


@dataclasses.dataclass(frozen=True)
class Surface:
    """Per-band absorption + scattering for one material.

    Both fields have shape ``(..., bands)``; a scene-wide table is a
    ``Surface`` whose leading axis indexes materials.
    """

    absorption: torch.Tensor
    scattering: torch.Tensor

    @classmethod
    def uniform(cls, absorption: float, scattering: float,
                bands: int = SIMULATION_BANDS, device="cpu") -> "Surface":
        return cls(
            absorption=torch.full((bands,), absorption, dtype=torch.float32,
                                  device=device),
            scattering=torch.full((bands,), scattering, dtype=torch.float32,
                                  device=device))

    def to(self, device) -> "Surface":
        return Surface(self.absorption.to(device), self.scattering.to(device))


def absorption_to_energy_reflectance(a):
    return 1.0 - a


def absorption_to_pressure_reflectance(a):
    return torch.sqrt(absorption_to_energy_reflectance(a))


def pressure_reflectance_to_average_wall_impedance(r):
    return (1.0 + r) / (1.0 - r)


def average_wall_impedance_to_pressure_reflectance(z, cos_angle):
    """Angle-dependent pressure reflectance from normalized wall impedance.

    ``cos_angle`` must be in [0, 1].
    """
    tmp = z * cos_angle
    return (tmp - 1.0) / (tmp + 1.0)


def pressure_reflectance_at_angle(normal_reflectance, cos_angle):
    """Angle-dependent reflectance directly from the normal-incidence value,
    stable at reflectance → 1 (zero absorption)."""
    num = cos_angle * (1.0 + normal_reflectance) - (1.0 - normal_reflectance)
    den = cos_angle * (1.0 + normal_reflectance) + (1.0 - normal_reflectance)
    return num / torch.clamp(den, min=1e-20)


def scattered_pressure(total_reflected, scattering):
    return total_reflected * scattering


def specular_pressure(total_reflected, scattering):
    return total_reflected * (1.0 - scattering)
