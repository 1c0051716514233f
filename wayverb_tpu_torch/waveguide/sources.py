"""Source preprocessors: how excitation enters the mesh each step.

Port of ``wayverb_tpu.waveguide.sources``.  A point source is a frozen
dataclass: its node is a static flat index (host int), its signal a device
tensor.  The Gaussian-ball sources spread a soft injection over a window of
nodes; ``PositionGaussianSource`` computes its weights from a continuous
position and differentiates with respect to it.  Nothing here reads a
device value back to the host, so the time loop never waits on the card.

Parity: reference ``waveguide/preprocessor/hard_source.h`` (overwrite node),
``soft_source.h`` (add), ``calibration.h:26-31`` (injection scale
√(Z/4π)/(0.3405·Δx)).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from wayverb_tpu_torch.waveguide.box_fused import PLANES
from wayverb_tpu_torch.waveguide.descriptor import MeshDescriptor


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


class _BallSource:
    """Shared machinery of the Gaussian-ball sources: a soft injection of
    ``weights() * signal[t]`` over a fixed window of nodes.  They have no
    ``kernel_injection``, so they run on the fused path."""

    node_indices: torch.Tensor   # (K,) int64 flat indices of the window
    signal: torch.Tensor         # (T,)

    def inject(self, field_flat, t: int):
        """Adds in place (the caller owns ``field_flat``)."""
        return field_flat.index_add_(
            0, self.node_indices,
            (self.weights() * self.signal[t]).to(field_flat.dtype))

    def patch_planes_stacked(self, stack, spec, dims, t: int):
        """Mirror the injection onto the stacked (6, U, V) inner planes, in
        place (the caller owns ``stack``)."""
        x, y, z = _unravel(self.node_indices, dims)
        xyz = (x, y, z)
        values = (self.weights() * self.signal[t]).to(stack.dtype)
        for pi, (a, s) in enumerate(PLANES):
            on = xyz[a] == (spec.ilo[a] if s == 0 else spec.ihi[a])
            u, v = _plane_uv(x, y, z, a)
            stack[pi].index_put_((u[on], v[on]), values[on], accumulate=True)
        return stack


@dataclasses.dataclass(frozen=True)
class GaussianSource(_BallSource):
    """Soft injection over a gaussian ball of nodes (reference
    ``preprocessor/gaussian.h``)."""

    node_indices: torch.Tensor   # (K,) flat indices within the ball support
    weight: torch.Tensor         # (K,) gaussian weights
    signal: torch.Tensor         # (T,)

    def weights(self):
        return self.weight


@dataclasses.dataclass(frozen=True)
class PositionGaussianSource(_BallSource):
    """Gaussian-ball soft source whose weights are a function of a
    continuous position: the IR differentiates with respect to ``position``.

    The support window (node indices and positions) is fixed at construction
    around the nominal position; gradients are exact for perturbations that
    keep the ball inside the window (``support_radius_cells`` of margin).
    """

    node_indices: torch.Tensor    # (K,) flat indices of the support window
    node_positions: torch.Tensor  # (K, 3) node positions
    position: torch.Tensor        # (3,) continuous source position
    sdev: float                   # spatial σ in metres
    signal: torch.Tensor          # (T,)

    def weights(self):
        d2 = torch.sum((self.node_positions - self.position[None, :]) ** 2,
                       dim=-1)
        return torch.exp(-d2 / (2.0 * self.sdev * self.sdev))


def _support_window(desc: MeshDescriptor, centre, support_radius_cells: int,
                    inside):
    """(K, 3) node coordinates of the cube of ±``support_radius_cells``
    nodes around ``centre``, clipped to the grid and, when ``inside`` is
    given, to inside nodes."""
    loc = desc.locator(centre)
    r = support_radius_cells
    offs = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    locs = loc[None, :] + offs
    dims = np.asarray(desc.dimensions)
    locs = locs[np.all((locs >= 0) & (locs < dims), axis=-1)]
    if inside is not None:
        inside = np.asarray(inside)
        locs = locs[inside[locs[:, 0], locs[:, 1], locs[:, 2]]]
    return locs


def _flat(desc: MeshDescriptor, locs, device) -> torch.Tensor:
    flat = np.ravel_multi_index((locs[:, 0], locs[:, 1], locs[:, 2]),
                                desc.dimensions)
    return torch.as_tensor(flat.astype(np.int64), device=device)


def make_gaussian_source(desc: MeshDescriptor, centre, sdev: float, signal,
                         support_radius_cells: int = 4, inside=None, *,
                         device) -> GaussianSource:
    """Gaussian ball centred at ``centre`` with spatial σ ``sdev`` metres.

    ``inside``: optional (X, Y, Z) bool mask; when given, the support is
    clipped to INSIDE nodes.  Injecting onto boundary nodes is meaningless
    (the boundary update overwrites them next step), so near-wall sources
    should pass the mesh's inside mask.
    """
    locs = _support_window(desc, centre, support_radius_cells, inside)
    d2 = np.sum((desc.position(locs) - np.asarray(centre)) ** 2, axis=-1)
    w = np.exp(-d2 / (2.0 * sdev * sdev))
    return GaussianSource(
        node_indices=_flat(desc, locs, device),
        weight=torch.as_tensor(w.astype(np.float32), device=device),
        signal=torch.as_tensor(signal, dtype=torch.float32, device=device))


def make_position_source(desc: MeshDescriptor, centre, sdev: float, signal,
                         inside, support_radius_cells: int = 4, *, device
                         ) -> PositionGaussianSource:
    """Differentiable-position source: a static inside-clipped support
    window around ``centre``, Gaussian weights computed from ``position``."""
    locs = _support_window(desc, centre, support_radius_cells, inside)
    return PositionGaussianSource(
        node_indices=_flat(desc, locs, device),
        node_positions=torch.as_tensor(
            np.asarray(desc.position(locs)).astype(np.float32),
            device=device),
        position=torch.as_tensor(np.asarray(centre, dtype=np.float32),
                                 device=device),
        sdev=float(np.float32(sdev)),
        signal=torch.as_tensor(signal, dtype=torch.float32, device=device))


def impulse_signal(num_steps: int, amplitude: float, device) -> torch.Tensor:
    """[amplitude, 0, 0, ...] — the canonical calibrated impulse input."""
    sig = torch.zeros(num_steps, dtype=torch.float32, device=device)
    sig[0] = amplitude
    return sig
