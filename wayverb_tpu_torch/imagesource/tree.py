"""Arbitrary-geometry image sources: dedupe traced specular paths, validate
them geometrically, and compute per-path 8-band pressure.

Port of ``wayverb_tpu.imagesource.tree``.  The candidate set comes straight
from the tracer's (depth, R) triangle history; dedupe is a host-side
``np.unique`` per order, and validation/mirroring/pressure are batched over
all paths of one order, on the soup's device.  Validation uses the dense
closest-hit test whatever backend traced the rays, as in the reference; that
test walks its rows in blocks (``core.geometry.DENSE_MAX_PAIRS``), so tens
of thousands of paths on thousands of triangles fit the device.

Pressure parity: ``fast_pressure_calculator.h:31-62`` — product over
bounces of angle-dependent reflectance (kuttruff eq 9.22) times the
specular (non-scattered) fraction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from wayverb_tpu_torch.core.geometry import (TriangleSoup, dot3, mirror_point,
                                             norm3, scene_intersection,
                                             triangle_normals)
from wayverb_tpu_torch.core.impulse import Impulses
from wayverb_tpu_torch.core.surfaces import (Surface,
                                             absorption_to_pressure_reflectance,
                                             pressure_reflectance_at_angle,
                                             specular_pressure)


def collect_paths(triangle_history, max_order: int) -> Dict[int, np.ndarray]:
    """Unique specular path prefixes per order.

    ``triangle_history``: (depth, R) int, -1 marks a dead ray (read back to
    the host).  Returns {order k: (P_k, k) int32}.
    """
    hist = np.asarray(triangle_history.cpu()
                      if torch.is_tensor(triangle_history)
                      else triangle_history)
    depth, _ = hist.shape
    out: Dict[int, np.ndarray] = {}
    for k in range(1, min(max_order, depth) + 1):
        prefix = hist[:k].T                                # (R, k)
        ok = np.all(prefix >= 0, axis=1)
        if not np.any(ok):
            continue
        out[k] = np.unique(prefix[ok], axis=0).astype(np.int32)
    return out


@dataclasses.dataclass
class ValidatedPaths:
    image_position: np.ndarray   # (P, 3) final image-source position
    cos_angles: np.ndarray       # (P, k)
    surfaces: np.ndarray         # (P, k) surface indices
    valid: np.ndarray            # (P,) bool


def validate_paths(paths: np.ndarray, soup: TriangleSoup, source,
                   receiver) -> ValidatedPaths:
    """Check each candidate path geometrically (batched over paths).

    Mirrors the source successively through the path's triangle planes,
    then casts back from the receiver through each expected triangle
    (tree.cpp:100-173): every segment must hit exactly the expected
    triangle, and the final segment must reach the source unobstructed.
    """
    device = soup.vertices.device
    paths = torch.as_tensor(paths, dtype=torch.int64, device=device)
    P, k = paths.shape
    corners = soup.corners()                               # (T, 3, 3)
    normals = triangle_normals(soup)
    source = torch.as_tensor(source, dtype=torch.float32, device=device)
    receiver = torch.as_tensor(receiver, dtype=torch.float32, device=device)

    # forward mirroring: images[j] = source mirrored through tris 0..j
    images = []
    img = source[None, :].expand(P, 3)
    for j in range(k):
        img = mirror_point(img, corners[paths[:, j]])
        images.append(img)

    # backward validation from the receiver
    valid = torch.ones(P, dtype=torch.bool, device=device)
    prev_pt = receiver[None, :].expand(P, 3)
    prev_tri = torch.full((P,), -1, dtype=torch.int64, device=device)
    cos_angles, surfaces = [], []
    for j in range(k - 1, -1, -1):
        direction = images[j] - prev_pt
        norm = norm3(direction)[:, None]
        direction = direction / torch.clamp(norm, min=1e-12)
        t, tri, hit = scene_intersection(prev_pt, direction, soup,
                                         exclude_triangle=prev_tri)
        valid = valid & hit & (tri == paths[:, j])
        hit_pt = prev_pt + direction * t[:, None]
        n = normals[paths[:, j]]
        cos_angles.append(torch.clamp(
            torch.abs(dot3(direction, n)), 0.0, 1.0))
        surfaces.append(soup.surfaces[paths[:, j]])
        prev_pt = hit_pt
        prev_tri = paths[:, j]

    # line of sight from the source to the first intersection point
    direction = prev_pt - source[None, :]
    dist = norm3(direction)
    direction = direction / torch.clamp(dist[:, None], min=1e-12)
    _, tri, hit = scene_intersection(source[None, :].expand(P, 3), direction,
                                     soup)
    valid = valid & hit & (tri == paths[:, 0])

    host = lambda x: x.cpu().numpy()  # noqa: E731
    return ValidatedPaths(
        image_position=host(images[-1]),
        cos_angles=host(torch.stack(cos_angles[::-1], dim=1)),
        surfaces=host(torch.stack(surfaces[::-1], dim=1)),
        valid=host(valid))


def compute_path_pressure(validated: ValidatedPaths, surfaces: Surface,
                          receiver, flip_phase: bool = False) -> Impulses:
    """Per-path 8-band pressure impulses (invalid paths carry zero volume),
    on the surfaces' device."""
    device = surfaces.absorption.device
    receiver = torch.as_tensor(receiver, dtype=torch.float32, device=device)
    surf_idx = torch.as_tensor(validated.surfaces, dtype=torch.int64,
                               device=device)                  # (P, k)
    cos = torch.as_tensor(validated.cos_angles,
                          device=device)[..., None]            # (P, k, 1)
    r0 = absorption_to_pressure_reflectance(
        surfaces.absorption[surf_idx])                         # (P, k, b)
    refl = pressure_reflectance_at_angle(r0, cos)
    outgoing = specular_pressure(refl, surfaces.scattering[surf_idx])
    if flip_phase:
        outgoing = -outgoing
    volume = torch.prod(outgoing, dim=1)                       # (P, bands)
    volume = volume * torch.as_tensor(validated.valid,
                                      device=device)[:, None]
    position = torch.as_tensor(validated.image_position, device=device)
    distance = norm3(position - receiver)
    return Impulses(volume=volume, position=position, distance=distance)


def find_image_source_impulses(triangle_history, soup: TriangleSoup,
                               surfaces: Surface, source, receiver,
                               max_order: int,
                               flip_phase: bool = False) -> Impulses:
    """Full pipeline: history → dedupe → validate → pressures (the direct
    path is not included — callers add ``exact.get_direct``)."""
    groups = collect_paths(triangle_history, max_order)
    results: List[Impulses] = []
    for _, paths in sorted(groups.items()):
        validated = validate_paths(paths, soup, source, receiver)
        if not np.any(validated.valid):
            continue
        keep = np.nonzero(validated.valid)[0]
        validated = ValidatedPaths(
            image_position=validated.image_position[keep],
            cos_angles=validated.cos_angles[keep],
            surfaces=validated.surfaces[keep],
            valid=validated.valid[keep])
        results.append(
            compute_path_pressure(validated, surfaces, receiver, flip_phase))
    if not results:
        device = surfaces.absorption.device
        bands = surfaces.absorption.shape[-1]
        return Impulses(volume=torch.zeros((0, bands), device=device),
                        position=torch.zeros((0, 3), device=device),
                        distance=torch.zeros((0,), device=device))
    total = results[0]
    for r in results[1:]:
        total = total.concatenate(r)
    return total
