"""Sabine / Eyring reverb-time prediction and room statistics.

Port of ``wayverb_tpu.core.reverb``, on the port's ``TriangleSoup`` and
``Surface``; results follow their inputs' device.

Parity: reference ``core/reverb_time.h:148-197`` (sabine/eyring, 0.161
constant), ``:107`` (volume estimate), air absorption per fu2015 eq. 11.
"""

from __future__ import annotations

import torch

from wayverb_tpu_torch.core.geometry import (TriangleSoup,
                                             tetrahedron_volume_sum,
                                             triangle_areas)


def equivalent_absorption_area(soup: TriangleSoup, absorption):
    """Σ area_i · α_i with per-band absorption (bands,).

    ``absorption``: (num_materials, bands), e.g. a ``Surface`` table's
    ``absorption``; per-triangle material comes from ``soup.surfaces``.
    """
    areas = triangle_areas(soup)                        # (T,)
    tri_abs = absorption[soup.surfaces.long()]          # (T, bands)
    return torch.sum(areas[:, None] * tri_abs, dim=0)   # (bands,)


def total_area(soup: TriangleSoup):
    return torch.sum(triangle_areas(soup))


def estimate_room_volume(soup: TriangleSoup):
    return tetrahedron_volume_sum(soup)


def sabine_reverb_time(room_volume, absorption_area, air_coefficient=0.0):
    """T60 = 0.161 V / (A + 4 V m)  (kuttruff 5.9)."""
    return 0.161 * room_volume / (
        absorption_area + 4.0 * room_volume * air_coefficient)


def eyring_reverb_time(room_volume, absorption_area, full_area,
                       air_coefficient=0.0):
    """T60 = 0.161 V / (-S ln(1 - A/S) + 4 V m)  (kuttruff 5.24)."""
    return 0.161 * room_volume / (
        -full_area * torch.log(1.0 - absorption_area / full_area)
        + 4.0 * room_volume * air_coefficient)


def estimate_air_intensity_absorption(frequency, humidity):
    """Air intensity absorption coefficient (fu2015 eq. 11)."""
    return (0.0275 / humidity) * torch.pow(
        torch.as_tensor(frequency) / 1000.0, 1.7)
