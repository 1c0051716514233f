"""Pressure / intensity conversions and distance laws.

Port of ``wayverb_tpu.core.pressure``.

Parity: reference ``core/pressure_intensity.h:8-23`` and
``core/src/pressure_intensity.cpp``.
"""

from __future__ import annotations

import math

import torch


def pressure_to_intensity(pressure, acoustic_impedance):
    return torch.copysign(pressure * pressure / acoustic_impedance, pressure)


def intensity_to_pressure(intensity, acoustic_impedance):
    return torch.copysign(
        torch.sqrt(torch.abs(intensity * acoustic_impedance)), intensity)


def intensity_for_distance(distance):
    """Spherical spreading: unit-strength source intensity at ``distance``."""
    return 1.0 / (4.0 * math.pi * distance * distance)


def pressure_for_distance(distance, acoustic_impedance):
    return math.sqrt(acoustic_impedance / (4.0 * math.pi)) / distance
