"""Stochastic ray tracer: the bounce loop, with every value on the device.

Port of ``wayverb_tpu.raytracer.tracer``.  The reference's ``lax.scan`` over
reflection depth becomes a Python loop over ``depth``; the ray state
(positions, directions, per-band energies) stays on the device and energy
is deposited into the directional histogram with masked scatter-adds.  Rays
are a batch axis.  Random directions come from a ``torch.Generator``, or are
passed in (``directions``) so a test can feed the reference's draws.

Physics parity:
 * reflection kernel ``src/program.cpp:51-153``: closest hit (excluding the
   launching triangle), receiver visibility, specular direction, Lambert
   scattering mix ``normalize(l·s̄ + spec·(1−s̄))`` with the mean scattering
   coefficient.
 * stochastic kernel ``src/stochastic/program.cpp:58-152``: per-band energy
   × (1−absorption); specular detection via segment–sphere crossing (volume
   BEFORE this bounce's wall loss, path from the previous position);
   diffuse rain per schroder2011 eq 5.20:
   ``(1−√(1−sin²γ))·2·cosθ·scattered``.
 * initial energy ``finder.h:18-25``: 2/(4π·N·d²·(1−cosγ)).
 * reflection count ``optimum_reflection_number.h:37-40``:
   ⌈−6/log₁₀(1−a_min)⌉.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.geometry import (TriangleSoup, dot3,
                                             line_of_sight,
                                             line_segment_sphere_intersection,
                                             norm3, scene_intersection, sqrt32,
                                             sum3, triangle_normals)
from wayverb_tpu_torch.core.orientation import (angle_lut_indices,
                                                random_unit_vectors)
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.raytracer.accel import (RayGrid, grid_intersection,
                                               grid_line_of_sight)
from wayverb_tpu_torch.raytracer.mt_kernels import (MtTriangles,
                                                    mt_intersection,
                                                    mt_line_of_sight)

DEFAULT_RECEIVER_RADIUS = 0.1      # simulation_parameters.h:25-33
DEFAULT_HISTOGRAM_SR = 1000.0
DIRECTIONAL_AZ = 20                # stochastic_histogram.h:210
DIRECTIONAL_EL = 9


def compute_optimum_reflection_number(min_absorption: float) -> int:
    return int(math.ceil(-6.0 / math.log10(1.0 - min_absorption)))


def compute_ray_energy(total_rays: int, source, receiver,
                       receiver_radius: float):
    """Initial per-ray energy, a () float32 tensor."""
    dist = norm3(receiver - source)
    # a source inside the receiver sphere would give infinite energy; the
    # engine validates placements, this clamp keeps the math finite anyway
    dist = torch.clamp(dist, min=receiver_radius)
    sin_y = receiver_radius / torch.clamp(dist, min=receiver_radius)
    cos_y = sqrt32(1.0 - sin_y * sin_y)
    return 2.0 / (4.0 * math.pi * total_rays * dist * dist * (1.0 - cos_y))


@dataclasses.dataclass
class TraceResults:
    """Everything one trace produces."""

    histogram: Any          # (bins, az, el, bands) directional energy
    triangle_history: Any   # (depth, R) int32 — hit triangle or -1
    histogram_sample_rate: float
    positions: Any = None   # (depth, R, 3) reflection points, if captured

    def summed_histogram(self):
        """(bins, bands) energy histogram (directional summed out)."""
        return torch.sum(self.histogram, dim=(1, 2))

    def max_time(self) -> float:
        """Time of the last nonzero histogram bin (max_stochastic_time); one
        read back to the host."""
        energy = torch.sum(self.summed_histogram(), dim=-1)
        nz = torch.nonzero(energy > 0)
        last = int(nz.max()) if nz.numel() else -1
        return (last + 1) / self.histogram_sample_rate


def _as_point(p, device):
    return torch.as_tensor(p, dtype=torch.float32, device=device)


def trace(soup: TriangleSoup, surfaces: Surface, source, receiver,
          generator: Optional[torch.Generator], num_rays: int, depth: int,
          max_time: float, environment: Environment = Environment(),
          receiver_radius: float = DEFAULT_RECEIVER_RADIUS,
          histogram_sample_rate: float = DEFAULT_HISTOGRAM_SR,
          max_image_source_order: int = 0,
          capture_positions: bool = False,
          accel=None, time_cutoff: Optional[float] = None,
          directions=None) -> TraceResults:
    """Trace ``num_rays`` rays for ``depth`` bounces on the soup's device.

    ``surfaces``: (S, bands) material table indexed by ``soup.surfaces``.
    Specular (non-scattered) receiver crossings only contribute from bounce
    ``max_image_source_order`` on — below that the image-source solver
    covers them deterministically.  ``accel``: None (the dense (R, T)
    broadcast), an ``accel.RayGrid`` (the voxel DDA) or an
    ``mt_kernels.MtTriangles`` (the Möller–Trumbore kernels), on the soup's
    device; ``accel.auto_accel`` picks one for a scene and a device.
    ``time_cutoff``: deposits later than it are dropped (``trace_jit``).
    ``capture_positions``: also return each bounce's reflection points,
    (depth, R, 3), for the visual mode (reference
    ``reflection_processor/visual.h``); a dead ray stays where it died.

    ``directions``: optional (initial (R, 3), per-bounce (depth, R, 3))
    unit vectors; otherwise they are drawn from ``generator``
    (``core.orientation.random_unit_vectors``).
    """
    device = soup.vertices.device
    if isinstance(accel, MtTriangles):
        intersect = lambda p, d, ex: mt_intersection(      # noqa: E731
            p, d, accel, exclude_triangle=ex)
        los = lambda a, b, ex: mt_line_of_sight(           # noqa: E731
            a, b, accel, exclude_triangle=ex)
    elif isinstance(accel, RayGrid):
        intersect = lambda p, d, ex: grid_intersection(    # noqa: E731
            p, d, accel, soup, exclude_triangle=ex)
        los = lambda a, b, ex: grid_line_of_sight(         # noqa: E731
            a, b, accel, soup, exclude_triangle=ex)
    elif accel is None:
        intersect = lambda p, d, ex: scene_intersection(   # noqa: E731
            p, d, soup, exclude_triangle=ex)
        los = lambda a, b, ex: line_of_sight(              # noqa: E731
            a, b, soup, exclude_triangle=ex)
    else:
        raise TypeError(f"trace: accel must be None, a RayGrid or an "
                        f"MtTriangles, got {type(accel).__name__}")
    source = _as_point(source, device)
    receiver = _as_point(receiver, device)
    bands = surfaces.absorption.shape[-1]
    bins = int(math.ceil(max_time * histogram_sample_rate)) + 1
    cells = DIRECTIONAL_AZ * DIRECTIONAL_EL

    if directions is not None:
        directions = tuple(torch.as_tensor(d, dtype=torch.float32,
                                           device=device) for d in directions)

    def draw(step):
        if directions is not None:
            return directions[0] if step is None else directions[1][step]
        return random_unit_vectors(num_rays, generator, device)

    starting_energy = compute_ray_energy(num_rays, source, receiver,
                                         receiver_radius)
    normals = triangle_normals(soup)                          # (T, 3)
    # each material's mean scattering, summed band by band as the CPU's
    # ``mean`` sums, so the card gives the same bits
    bands_s = surfaces.scattering.unbind(-1)
    mean_scattering = bands_s[0]
    for band in bands_s[1:]:
        mean_scattering = mean_scattering + band
    mean_scattering = mean_scattering / len(bands_s)
    speed = environment.speed_of_sound
    tri_surfaces = soup.surfaces.long()

    dirs = draw(None)
    pos = source[None, :].expand(num_rays, 3)
    alive = torch.ones(num_rays, dtype=torch.bool, device=device)
    volume = starting_energy.expand(num_rays, bands)
    path_pos = pos
    path_dist = torch.zeros(num_rays, device=device)
    prev_tri = torch.full((num_rays,), -1, dtype=torch.int64, device=device)
    # flat (bins·az·el, bands) histogram plus one spare row that takes the
    # dropped deposits (masked out, or past the last bin)
    trash = bins * cells
    hist = torch.zeros((trash + 1, bands), device=device)
    recv_rows = receiver[None, :].expand(num_rays, 3)

    def deposit(positions, distances, volumes, mask):
        """Masked scatter-add of impulses into the directional histogram."""
        times = distances / speed
        if time_cutoff is not None:
            mask = mask & (times <= time_cutoff)
        bin_idx = torch.floor(times * histogram_sample_rate).to(torch.int64)
        az, el = angle_lut_indices(positions - receiver, DIRECTIONAL_AZ,
                                   DIRECTIONAL_EL)
        row = (bin_idx * DIRECTIONAL_AZ + az) * DIRECTIONAL_EL + el
        row = torch.where(mask & (bin_idx >= 0) & (bin_idx < bins), row,
                          torch.full_like(row, trash))
        hist.index_add_(0, row, torch.where(mask[:, None], volumes,
                                            torch.zeros_like(volumes)))

    history, points = [], []
    for step in range(depth):
        t, tri, hit = intersect(pos, dirs, prev_tri)
        tri = tri.long()           # the MT and DDA backends give int32 ids
        alive = alive & hit
        ipt = pos + dirs * t[:, None]

        tri_surface = tri_surfaces[tri]
        absorption = surfaces.absorption[tri_surface]          # (R, bands)
        scattering = surfaces.scattering[tri_surface]
        reflectance = 1.0 - absorption

        last_volume = volume
        outgoing = last_volume * reflectance
        last_pos = path_pos
        last_dist = path_dist
        this_dist = last_dist + norm3(ipt - last_pos)

        # specular detection: the segment from the previous reflection point
        # crosses the receiver sphere; energy BEFORE this wall's absorption
        crosses = line_segment_sphere_intersection(last_pos, ipt, receiver,
                                                   receiver_radius)
        spec_dist = last_dist + norm3(receiver - last_pos)
        spec_mask = alive & crosses & (step >= max_image_source_order)
        deposit(last_pos, spec_dist, last_volume, spec_mask)

        # diffuse rain toward the visible receiver
        visible = los(ipt, recv_rows, tri)
        to_recv = receiver - ipt
        to_recv_dist = norm3(to_recv)
        n = normals[tri]
        cos_angle = torch.abs(sum3(
            n * to_recv / torch.clamp(to_recv_dist[:, None], min=1e-12)))
        sin_y = receiver_radius / torch.clamp(to_recv_dist,
                                              min=receiver_radius)
        angle_correction = 1.0 - sqrt32(torch.clamp(1.0 - sin_y ** 2,
                                                    min=0.0))
        rain_volume = (angle_correction * 2.0 * cos_angle)[:, None] * \
            outgoing * scattering
        deposit(ipt, this_dist + to_recv_dist, rain_volume, alive & visible)

        # next ray: lambert-mixed scattering around the specular direction
        spec_dir = dirs - 2.0 * dot3(dirs, n)[:, None] * n
        # flip normal to the side the specular leaves from
        n_oriented = n * torch.sign(dot3(n, spec_dir))[:, None]
        rand = draw(step)
        lambert = rand * torch.sign(dot3(rand, n_oriented))[:, None]
        s_mean = mean_scattering[tri_surface][:, None]
        new_dir = lambert * s_mean + spec_dir * (1.0 - s_mean)
        new_dir = new_dir / torch.clamp(norm3(new_dir)[:, None], min=1e-12)

        a1 = alive[:, None]
        pos = torch.where(a1, ipt, pos)
        dirs = torch.where(a1, new_dir, dirs)
        volume = torch.where(a1, outgoing, volume)
        path_pos = torch.where(a1, ipt, last_pos)
        path_dist = torch.where(alive, this_dist, last_dist)
        prev_tri = torch.where(alive, tri, prev_tri)
        history.append(torch.where(alive, tri, torch.full_like(tri, -1)))
        if capture_positions:
            points.append(pos)

    return TraceResults(
        histogram=hist[:trash].reshape(bins, DIRECTIONAL_AZ, DIRECTIONAL_EL,
                                       bands),
        triangle_history=torch.stack(history).to(torch.int32),
        histogram_sample_rate=histogram_sample_rate,
        positions=torch.stack(points) if capture_positions else None)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def trace_jit(soup, surfaces, source, receiver, generator, num_rays: int,
              depth: int, max_time: float, **kwargs) -> TraceResults:
    """``trace`` with the reference ``trace_jit``'s histogram length.

    ``max_time`` is padded to the next power-of-two multiple of 0.25 s and
    deposits past the requested ``max_time`` are dropped, so the histogram's
    bin count — and the rendered IR's length — match the reference.  The
    reference also pads ``depth`` to a power of two to reuse compiled
    scans; bounces past the requested depth are dead there, so the port
    runs ``depth`` bounces and its ``triangle_history`` has ``depth`` rows.
    """
    pad_time = 0.25 * _next_pow2(
        max(int(math.ceil(float(max_time) / 0.25)), 1))
    return trace(soup, surfaces, source, receiver, generator,
                 num_rays=num_rays, depth=depth, max_time=pad_time,
                 time_cutoff=float(max_time), **kwargs)
