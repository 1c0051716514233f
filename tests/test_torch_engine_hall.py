"""The hybrid engine on a hall above 100 triangles against the JAX engine.

``Engine.run`` + ``render`` on ``procedural_hall(3, 2, 1)`` (132 triangles,
two columns) without ``scene_box``, at a 400 Hz cutoff, on the CPU: both
packages pick the voxel DDA for the ray tracer (``auto_accel``) and validate
image sources on the dense broadcast.  The reference's random draws are fed
to the port.

The waveguide band agrees within 1e-4 of its peak and the image sources
exactly.  About 25 of the 1,024 rays part ways with the reference's at some
bounce: a hit that float32 rounding flips between two triangles of a shared
edge (the tessellated hall has many).  The tests hold that cause itself:
≥ 97 % of the rays keep the reference's triangle history at every bounce;
with the histograms of both packages traced from those rays alone (the
diverging rays taken out of both, same draws), the rendered IR agrees within
1e-4 of its peak, the bound of the 96-triangle hall of
``test_torch_general.py``; and the full histograms differ by no more than
the energy that the diverging rays deposit.  With the diverging rays in, each
moves single bins of the stochastic tail and the IR stays within 1e-3 of its
peak (the bound of ``test_torch_engine.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_dirac_draws, reference_directions
from wayverb_tpu.combined import engine as jeng
from wayverb_tpu.core.attenuator import Null as JNull
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu.raytracer import accel as jaccel
from wayverb_tpu.raytracer import scenes as jscenes
from wayverb_tpu.raytracer import tracer as jtracer
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.combined import engine as teng
from wayverb_tpu_torch.core.attenuator import Null
from wayverb_tpu_torch.raytracer import accel as taccel
from wayverb_tpu_torch.raytracer import scenes as tscenes
from wayverb_tpu_torch.raytracer import tracer as ttracer

torch.set_num_threads(2)

HALL = (3, 2, 1)
SRC, RCV = (6.0, 4.0, 5.0), (7.5, 3.0, 6.5)
RAYS = 1024
SR = 16000.0
PARAMS = dict(rays=RAYS, max_time=0.5)


@pytest.fixture(scope="module")
def hall_engines():
    wparams = dict(cutoff=400.0, usable_portion=0.6)
    je = jeng.Engine(jscenes.procedural_hall(*HALL)[0],
                     JSurface(absorption=jnp.full((1, 8), 0.1),
                              scattering=jnp.full((1, 8), 0.1)),
                     jeng.WaveguideParameters(**wparams))
    te = teng.Engine(tscenes.procedural_hall(*HALL)[0],
                     convert.surface_from_numpy(np.full((1, 8), 0.1),
                                                np.full((1, 8), 0.1)),
                     teng.WaveguideParameters(**wparams), device="cpu")
    key = jax.random.PRNGKey(0)
    want = je.run(SRC, RCV, key, jeng.RaytracerParameters(**PARAMS),
                  waveguide_time=0.05)
    depth = teng.optimum_depth(te.surfaces)
    got = te.run(SRC, RCV, None, teng.RaytracerParameters(**PARAMS),
                 waveguide_time=0.05,
                 directions=reference_directions(key, RAYS, depth))
    return je, te, want, got


def _trace_args(params):
    return dict(max_time=params.max_time,
                receiver_radius=params.receiver_radius,
                histogram_sample_rate=params.histogram_sample_rate,
                max_image_source_order=params.maximum_image_source_order)


@pytest.fixture(scope="module")
def hall_traces(hall_engines):
    """The engines' own trace calls made again, for the triangle histories
    (``run`` does not return them), then both packages' histograms traced
    from the rays that keep one history in both: (share of such rays, the
    two full histograms, the two histograms of those rays alone)."""
    je, te, want, got = hall_engines
    key = jax.random.PRNGKey(0)
    depth = teng.optimum_depth(te.surfaces)
    init, bounce = reference_directions(key, RAYS, depth)
    jp, tp = jeng.RaytracerParameters(**PARAMS), \
        teng.RaytracerParameters(**PARAMS)
    jfull = jtracer.trace_jit(je.soup, je.surfaces, SRC, RCV, key,
                              num_rays=RAYS, depth=depth, accel=je.ray_grid,
                              **_trace_args(jp))
    tfull = ttracer.trace_jit(te.soup, te.surfaces, SRC, RCV, None,
                              num_rays=RAYS, depth=depth, accel=te.ray_grid,
                              directions=(init, bounce), **_trace_args(tp))
    # these are the traces the engines ran
    assert np.array_equal(np.asarray(jfull.histogram),
                          np.asarray(want.stochastic_histogram))
    assert torch.equal(tfull.histogram, got.stochastic_histogram)
    jhist = np.asarray(jfull.triangle_history)
    assert np.all(jhist[depth:] == -1)
    same = np.all(tfull.triangle_history.numpy() == jhist[:depth], axis=0)
    keep = np.flatnonzero(same)

    # The reference draws its directions from the key inside ``trace``: give
    # it the draws of all RAYS rays, cut to the kept ones.  A ray's starting
    # energy is 1 / num_rays of the source's, so both packages trace
    # len(keep) rays and the histograms are scaled back to RAYS rays.
    draw = jtracer.random_unit_vectors
    jtracer.random_unit_vectors = lambda k, n: draw(k, RAYS)[keep]
    try:
        jkept = jtracer.trace_jit(je.soup, je.surfaces, SRC, RCV, key,
                                  num_rays=len(keep), depth=depth,
                                  accel=je.ray_grid, **_trace_args(jp))
    finally:
        jtracer.random_unit_vectors = draw
    tkept = ttracer.trace_jit(te.soup, te.surfaces, SRC, RCV, None,
                              num_rays=len(keep), depth=depth,
                              accel=te.ray_grid,
                              directions=(init[keep], bounce[:, keep]),
                              **_trace_args(tp))
    assert np.array_equal(np.asarray(jkept.triangle_history)[:depth],
                          jhist[:depth, keep])
    assert np.array_equal(tkept.triangle_history.numpy(), jhist[:depth, keep])
    scale = len(keep) / RAYS
    return (same.mean(), np.asarray(jfull.histogram), tfull.histogram.numpy(),
            np.asarray(jkept.histogram) * scale,
            tkept.histogram.numpy() * scale)


def test_engine_run_matches_on_hall_above_dense_limit(hall_engines):
    je, te, want, got = hall_engines
    assert te.soup.num_triangles == 132 > taccel.DENSE_MAX_TRIANGLES
    assert isinstance(je.ray_grid, jaccel.RayGrid)
    assert isinstance(te.ray_grid, taccel.RayGrid)
    assert np.array_equal(te.ray_grid.cells.numpy(),
                          np.asarray(je.ray_grid.cells))
    assert te.mesh.box_spec is None and te.mesh.regions is None
    wb, gb = want.waveguide_bands[0], got.waveguide_bands[0]
    assert gb.pressure.shape == np.asarray(wb.pressure).shape
    np.testing.assert_allclose(gb.pressure.numpy(), np.asarray(wb.pressure),
                               rtol=0, atol=1e-4 * np.abs(wb.pressure).max())
    assert got.room_volume == pytest.approx(want.room_volume)
    assert got.image_source.count == want.image_source.count > 1
    np.testing.assert_allclose(
        np.sort(got.image_source.distance.numpy()),
        np.sort(np.asarray(want.image_source.distance)), rtol=1e-6)
    assert got.stochastic_histogram.shape == want.stochastic_histogram.shape
    g = got.stochastic_histogram.numpy().sum(axis=(0, 1, 2))
    w = np.asarray(want.stochastic_histogram).sum(axis=(0, 1, 2))
    np.testing.assert_allclose(g, w, rtol=1e-3)


def _rendered(want, got):
    key = jax.random.PRNGKey(1)
    w = np.asarray(jeng.render(want, JNull(), SR, key))
    n = int(np.ceil(got.stochastic_histogram.shape[0]
                    / got.histogram_sample_rate * SR))
    g = teng.render(got, Null(), SR,
                    draws=reference_dirac_draws(key, n)).numpy()
    assert g.shape == w.shape
    assert np.all(np.isfinite(g)) and np.abs(w).max() > 0
    return g, w


def test_engine_render_matches_on_hall_above_dense_limit(hall_engines,
                                                         hall_traces):
    """The rendered IR within 1e-4 of its peak with the diverging rays taken
    out of both packages' histograms, and within 1e-3 with them in."""
    _, _, want, got = hall_engines
    _, jfull, _, jkept, tkept = hall_traces
    g, w = _rendered(
        dataclasses.replace(want, stochastic_histogram=jnp.asarray(jkept)),
        dataclasses.replace(got, stochastic_histogram=torch.from_numpy(
            tkept)))
    # the tail still carries nearly all of the histogram's energy
    assert jkept.sum() >= 0.95 * jfull.sum()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    g, w = _rendered(want, got)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())


def test_histograms_differ_by_the_diverging_rays_alone(hall_traces):
    """≥ 97 % of the rays keep the reference's triangle history; the rays
    that do deposit the same energy in both packages, bin for bin, and the
    full histograms differ by at most what the others deposit."""
    same, jfull, tfull, jkept, tkept = hall_traces
    assert 0.97 <= same < 1.0, same
    total = jfull.sum()
    assert np.abs(tkept - jkept).sum() <= 1e-5 * total
    diverging = (jfull.sum() - jkept.sum()) + (tfull.sum() - tkept.sum())
    assert 0 < diverging <= 0.05 * total
    assert np.abs(tfull - jfull).sum() <= diverging + 1e-5 * total

