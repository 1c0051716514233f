"""The README's ray-leg oracle rows, run on the port (CPU, torch draws).

The same oracles ``tests/test_raytracer.py`` holds the JAX package to, with
the same bounds: the direct specular energy against 1/(4πr²), the tail's
decay rate against Sabine, and traced + validated image sources against
the exact shoebox lattice.  The random draws are the port's own
(``torch.Generator``), so the bounds are statistical where the oracle is.
"""

import math

import numpy as np
import torch

from wayverb_tpu_torch.core.geometry import Box, box_scene
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.imagesource import exact
from wayverb_tpu_torch.imagesource.tree import find_image_source_impulses
from wayverb_tpu_torch.raytracer import tracer

torch.set_num_threads(2)

BOX = Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
SOURCE = (2.09, 2.12, 2.12)
RECEIVER = (2.09, 3.08, 0.96)


def _surfaces(absorption, scattering):
    return Surface(absorption=torch.full((1, 8), absorption),
                   scattering=torch.full((1, 8), scattering))


def test_direct_specular_energy_matches_inverse_square():
    """With no image-source order, the direct specular detection deposits
    ≈ 1/(4πr²) of the total energy; ~112 crossing rays, so rtol 0.3."""
    res = tracer.trace_jit(box_scene(BOX), _surfaces(1.0, 0.0), SOURCE,
                           RECEIVER, torch.Generator().manual_seed(0),
                           num_rays=100000, depth=1, max_time=0.2,
                           max_image_source_order=0)
    total = res.summed_histogram().sum(dim=0).numpy()
    r = np.linalg.norm(np.subtract(SOURCE, RECEIVER))
    np.testing.assert_allclose(total, 1.0 / (4 * np.pi * r * r), rtol=0.3)
    bins = res.summed_histogram()[:, 0]
    assert int(bins.argmax()) == int(r / 340.0 * 1000.0)


def test_decay_slope_tracks_sabine():
    """The tail's energy decay rate against Sabine, rtol 0.15, with the
    optimum reflection number of bounces."""
    box = Box((0, 0, 0), (4.5, 2.5, 3.5))
    a = 0.1
    depth = tracer.compute_optimum_reflection_number(a)
    assert depth == 132
    res = tracer.trace_jit(box_scene(box), _surfaces(a, 0.1),
                           (1.5, 1.2, 1.0), (3.0, 1.4, 2.5),
                           torch.Generator().manual_seed(4), num_rays=10000,
                           depth=depth, max_time=1.2)
    hist = res.summed_histogram()[:, 0].numpy()
    t = np.arange(len(hist)) / 1000.0
    sel = (hist > 0) & (t > 0.05) & (t < 0.8)
    slope = np.polyfit(t[sel], 10 * np.log10(hist[sel]), 1)[0]   # dB/s
    dims = np.asarray(box.max_corner)
    sabine = 0.161 * np.prod(dims) / (
        2 * (dims[0] * dims[1] + dims[1] * dims[2] + dims[0] * dims[2]) * a)
    np.testing.assert_allclose(-60.0 / slope, sabine, rtol=0.15)


def test_traced_image_sources_match_exact_lattice():
    """Every traced + validated first/second-order path is a lattice image:
    distance within 1e-3 m and magnitude within 1e-3 relative; at least the
    six first-order walls are found."""
    soup = box_scene(BOX)
    surfaces = _surfaces(0.1, 0.0)
    res = tracer.trace_jit(soup, surfaces, SOURCE, RECEIVER,
                           torch.Generator().manual_seed(5), num_rays=20000,
                           depth=3, max_time=0.5)
    found = find_image_source_impulses(res.triangle_history, soup, surfaces,
                                       SOURCE, RECEIVER, max_order=2)
    oracle = exact.find_impulses(BOX, SOURCE, RECEIVER,
                                 torch.full((8,), 0.1), max_distance=25.0)
    o_vol = oracle.volume[:, 0].numpy()
    o_dist = oracle.distance.numpy()
    active = np.abs(o_vol) > 0
    f_dist = found.distance.numpy()
    assert len(f_dist) >= 6
    for d, v in zip(f_dist, found.volume[:, 0].numpy()):
        assert np.min(np.abs(o_dist[active] - d)) < 1e-3, d
        i = np.abs(o_dist - d).argmin()
        assert math.isclose(v, o_vol[i], rel_tol=1e-3), (d, v, o_vol[i])
