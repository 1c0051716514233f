"""Global acoustic environment parameters.

Parity: reference ``core/environment.h:6-13`` (speed_of_sound=340,
acoustic_impedance=400, ambient density = Z/c).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Environment:
    """Physical medium parameters shared by all solvers."""

    speed_of_sound: float = 340.0
    acoustic_impedance: float = 400.0

    @property
    def ambient_density(self) -> float:
        return self.acoustic_impedance / self.speed_of_sound


def ambient_density(env: Environment) -> float:
    return env.ambient_density
