"""Receiver capsule models: omni/null and polar-pattern microphone.

Port of ``Null`` and ``Microphone`` from ``wayverb_tpu.core.attenuator``.
``Hrtf`` waits for the slice that ports its table.

Parity: reference ``core/attenuator/microphone.cpp:18-25`` (gain =
(1-s) + s·cosθ), ``core/attenuator/null.h``.
"""

from __future__ import annotations

import dataclasses

import torch

from wayverb_tpu_torch.core.orientation import Orientation


@dataclasses.dataclass(frozen=True)
class Null:
    """Omnidirectional: unit gain."""

    def attenuation(self, incident):
        return torch.ones(incident.shape[:-1], dtype=incident.dtype,
                          device=incident.device)


@dataclasses.dataclass(frozen=True)
class Microphone:
    """First-order polar pattern: shape 0 = omni, 0.5 = cardioid, 1 = fig-8."""

    orientation: Orientation = Orientation()
    shape: float = 0.0

    def attenuation(self, incident):
        """Gain for incident direction vectors (..., 3) (toward the event)."""
        length = torch.linalg.vector_norm(incident, dim=-1)
        unit = incident / torch.clamp(length[..., None], min=1e-20)
        pointing = self.orientation.matrix(incident.device)[2]
        cos = torch.sum(unit * pointing, dim=-1)
        gain = (1.0 - self.shape) + self.shape * cos
        return torch.where(length > 0, gain, torch.zeros_like(gain))
