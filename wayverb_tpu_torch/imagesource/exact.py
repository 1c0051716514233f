"""Exact image-source solver for shoebox rooms.

Port of ``wayverb_tpu.imagesource.exact``.  For a cuboid the image lattice
is closed-form (aretz p.71): image (i,j,k) mirrors the source i times in x,
j in y, k in z; angle-dependent wall reflectance accumulates per axis.  The
whole lattice is one (L, 3) batch.

Parity: reference ``raytracer/image_source/exact.h:50-100`` + ``exact.cpp``
(lattice position via odd/even fold, reflectance = Π_axis
r(z, cosθ_axis)^|order_axis|), ``get_direct.h`` (line-of-sight impulse).
"""

from __future__ import annotations

import math

import torch

from wayverb_tpu_torch.core.geometry import (Box, TriangleSoup, line_of_sight,
                                             norm3)
from wayverb_tpu_torch.core.impulse import Impulses
from wayverb_tpu_torch.core.surfaces import (
    absorption_to_pressure_reflectance, pressure_reflectance_at_angle)


def image_source_positions(orders, source, dim):
    """Lattice positions for integer orders (L, 3).

    Even order along an axis keeps the source coordinate, odd order folds it
    to ``dim - source``; every order adds ``order · dim``.
    """
    folded = torch.where(orders % 2 == 0, source, dim - source)
    return orders * dim + folded


def find_impulses(box: Box, source, receiver, surface_absorption,
                  max_distance: float) -> Impulses:
    """All image-source impulses within ``max_distance``.

    ``surface_absorption``: (bands,) shared by all six walls.  Images beyond
    range carry zero volume, on ``surface_absorption``'s device.  Returned
    volumes do NOT include 1/r — apply
    ``core.impulse.apply_distance_pressure`` for pressure IRs.
    """
    device = torch.as_tensor(surface_absorption).device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                    device=device)
    lo = f32(box.min_corner)
    dim = f32(box.max_corner) - lo
    src = f32(source) - lo
    rcv = f32(receiver) - lo

    shells = [int(math.ceil(max_distance / float(d))) for d in dim]
    axes = [torch.arange(-s, s + 1, device=device) for s in shells]
    gi, gj, gk = torch.meshgrid(*axes, indexing="ij")
    orders = torch.stack([gi.reshape(-1), gj.reshape(-1), gk.reshape(-1)],
                         dim=-1)                                  # (L, 3)

    positions = image_source_positions(orders, src, dim)          # (L, 3)
    diff = positions - rcv
    distance = norm3(diff)
    cos_theta = torch.abs(diff) / torch.clamp(distance[:, None], min=1e-8)

    r0 = absorption_to_pressure_reflectance(f32(surface_absorption))
    # per-axis angle-dependent reflectance, then |order| reflections per axis
    refl = pressure_reflectance_at_angle(r0[None, None, :],
                                         cos_theta[:, :, None])   # (L,3,b)
    volume = torch.prod(refl ** torch.abs(orders)[:, :, None], dim=1)

    in_range = distance < max_distance
    volume = torch.where(in_range[:, None], volume, torch.zeros_like(volume))
    return Impulses(volume=volume, position=positions + lo,
                    distance=distance)


def get_direct(source, receiver, soup: TriangleSoup, bands: int = 8
               ) -> Impulses:
    """Line-of-sight impulse (unit volume) — zero volume when occluded."""
    device = soup.vertices.device
    source = torch.as_tensor(source, dtype=torch.float32, device=device)
    receiver = torch.as_tensor(receiver, dtype=torch.float32, device=device)
    visible = line_of_sight(source[None, :], receiver[None, :], soup)[0]
    dist = norm3(receiver - source)
    on = (visible & (dist > 0)).to(torch.float32)
    volume = on * torch.ones((1, bands), device=device)
    return Impulses(volume=volume, position=source[None, :],
                    distance=dist[None])
