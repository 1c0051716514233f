"""Receiver capsule models: omni/null, polar-pattern microphone, HRTF.

Port of ``wayverb_tpu.core.attenuator``.  All attenuation functions
broadcast over a batch of incident vectors and are differentiable in them
(the HRTF gains are table reads: their gradient in the direction is zero).

Parity: reference ``core/attenuator/microphone.cpp:18-25`` (gain =
(1-s) + s·cosθ), ``core/attenuator/hrtf.cpp:119-139`` (az/el table lookup of
2-channel 8-band energies; ear offset ±radius along the local x axis),
``core/attenuator/null.h``.  The reference's IRCAM table is not copied: the
default table is the Brown–Duda model of ``core.hrtf``, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from wayverb_tpu_torch.core.geometry import dot3, norm3
from wayverb_tpu_torch.core.hrtf import default_hrtf_table, table_from_energies
from wayverb_tpu_torch.core.orientation import Orientation, angle_lut_indices


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
        length = norm3(incident)
        unit = incident / torch.clamp(length[..., None], min=1e-20)
        pointing = self.orientation.matrix(incident.device)[2]
        cos = dot3(unit, pointing)
        gain = (1.0 - self.shape) + self.shape * cos
        return torch.where(length > 0, gain, torch.zeros_like(gain))


@dataclasses.dataclass(frozen=True)
class Hrtf:
    """Head-related capsule: per-direction 8-band energies, two ears.

    ``table``: (az, el, 2, bands) energy table (default: ``core.hrtf``'s
    Brown–Duda table); ``channel``: 0=left 1=right; ``radius``: ear offset
    from head centre in metres.

    A direction is rotated by the orientation's matrix made on the host and
    binned, both in float64, where the reference rotates and bins in
    float32: float32 matrix products, ``atan2`` and ``asin`` round
    differently on the card and on the CPU, and a direction near a bin edge
    would then read another bin.  In float64 only a direction within an ulp
    or so of an edge can still part (the card's and the host's float64
    ``atan2`` / ``asin`` may differ in the last bit), so the card and the
    CPU read the same entries with high probability, not by construction;
    and a direction within float32 rounding of an edge may read another
    entry than the reference's.
    """

    orientation: Orientation = Orientation()
    channel: int = 0
    radius: float = 0.1
    table: Any = None

    def _table(self, device):
        if self.table is not None:
            return table_from_energies(self.table, device)
        return default_hrtf_table(device)

    def attenuation(self, incident):
        """(..., bands) per-band gains for incident vectors (..., 3)."""
        table = self._table(incident.device)
        num_az, num_el = table.shape[0], table.shape[1]
        length = torch.linalg.vector_norm(incident, dim=-1)
        v = incident.to(torch.float64)
        unit = v / torch.clamp(
            torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
        rotation = self.orientation.matrix("cpu").to(incident.device,
                                                     torch.float64)
        az, el = angle_lut_indices(unit @ rotation.T, num_az, num_el)
        gains = table[az.long(), el.long(), self.channel]
        return torch.where(length[..., None] > 0, gains,
                           torch.zeros_like(gains))

    def ear_position(self, base_position):
        """The ear: ``base_position`` moved ±``radius`` along the head's
        local x axis, on the base position's device."""
        base = torch.as_tensor(base_position, dtype=torch.float32)
        offset = -self.radius if self.channel == 0 else self.radius
        x_axis = self.orientation.matrix("cpu")[0].to(base.device)
        return base + offset * x_axis
