"""Source preprocessors: how excitation enters the mesh each step.

Port of the point sources of ``wayverb_tpu.waveguide.sources``.  A source is
a frozen dataclass: its node is a static flat index (host int), its signal a
device tensor.  Nothing here reads a device value back to the host, so the
time loop never waits on the card.

Parity: reference ``waveguide/preprocessor/hard_source.h`` (overwrite node),
``soft_source.h`` (add), ``calibration.h:26-31`` (injection scale
√(Z/4π)/(0.3405·Δx)).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from wayverb_tpu_torch.waveguide.box_fused import PLANES


def _unravel(flat_idx: int, dims):
    """flat (C-order) → (x, y, z) coordinates."""
    yz = dims[1] * dims[2]
    return flat_idx // yz, (flat_idx % yz) // dims[2], flat_idx % dims[2]


def _plane_uv(x, y, z, axis):
    if axis == 0:
        return y, z
    if axis == 1:
        return x, z
    return x, y


def _inner_plane_targets(node_idx: int, spec, dims):
    """[(plane, u, v)] for each of the six carried inner planes of the fused
    box solver (box_fused.PLANES order) that the node lies on."""
    xyz = _unravel(node_idx, dims)
    out = []
    for pi, (a, s) in enumerate(PLANES):
        coord = spec.ilo[a] if s == 0 else spec.ihi[a]
        if xyz[a] == coord:
            out.append((pi,) + _plane_uv(*xyz, a))
    return out


def rectilinear_calibration_factor(grid_spacing: float,
                                   acoustic_impedance: float) -> float:
    """Level-matching injection scale (siltanen2013; calibration.h)."""
    distance_for_unit_pressure = math.sqrt(acoustic_impedance / (4 * math.pi))
    return distance_for_unit_pressure / (0.3405 * grid_spacing)


class _PointSource:
    """Shared machinery of the hard and soft point sources."""

    node_idx: int            # static flat node index
    signal: torch.Tensor     # (T,) on the field's device
    MODE = 0

    @functools.cached_property
    def _injection_table(self) -> torch.Tensor:
        """(T, 2) device table of (signal[t], signal[t-1] or 0) rows: the
        fused kernel's per-step injection values are a view, not a launch."""
        sig = self.signal.to(torch.float32)
        prev = torch.cat([torch.zeros_like(sig[:1]), sig[:-1]])
        return torch.stack([sig, prev], dim=1)

    def kernel_injection(self, dims, t: int):
        """(inj_idx, inj_val) for the fused kernel's in-kernel injection:
        host ints (x, y, z, mode) and a (2,) device view."""
        return (_unravel(self.node_idx, dims) + (self.MODE,),
                self._injection_table[t])


@dataclasses.dataclass(frozen=True)
class HardSource(_PointSource):
    """Overwrite the source node's pressure with signal[t]."""

    node_idx: int
    signal: torch.Tensor
    MODE = 1

    def inject(self, field_flat, t: int):
        """Sets the node in place (the caller owns ``field_flat``)."""
        field_flat[self.node_idx] = self.signal[t].to(field_flat.dtype)
        return field_flat

    def patch_planes_stacked(self, stack, spec, dims, t: int):
        """Mirror the injection onto the stacked (6, U, V) inner planes, in
        place (the caller owns ``stack``)."""
        for pi, u, v in _inner_plane_targets(self.node_idx, spec, dims):
            stack[pi, u, v] = self.signal[t].to(stack.dtype)
        return stack

    def patch_tap(self, idx, values, t: int):
        """Apply the pending injection to values gathered at flat ``idx``."""
        return torch.where(idx == self.node_idx,
                           self.signal[t].to(values.dtype), values)


@dataclasses.dataclass(frozen=True)
class SoftSource(_PointSource):
    """Add signal[t] to the source node's pressure."""

    node_idx: int
    signal: torch.Tensor
    MODE = 2

    def inject(self, field_flat, t: int):
        """Adds in place (the caller owns ``field_flat``)."""
        field_flat[self.node_idx] += self.signal[t].to(field_flat.dtype)
        return field_flat

    def patch_planes_stacked(self, stack, spec, dims, t: int):
        for pi, u, v in _inner_plane_targets(self.node_idx, spec, dims):
            stack[pi, u, v] += self.signal[t].to(stack.dtype)
        return stack

    def patch_tap(self, idx, values, t: int):
        return values + torch.where(
            idx == self.node_idx, self.signal[t].to(values.dtype),
            torch.zeros_like(values))


def impulse_signal(num_steps: int, amplitude: float, device) -> torch.Tensor:
    """[amplitude, 0, 0, ...] — the canonical calibrated impulse input."""
    sig = torch.zeros(num_steps, dtype=torch.float32, device=device)
    sig[0] = amplitude
    return sig
