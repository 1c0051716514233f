"""The port's ray leg against the JAX reference, on the CPU.

Geometry queries take the same numpy rays as the JAX functions.  ``trace``
runs on the ``test_combined.py`` box with the reference's own random draws
fed in (``jax.random`` streams cannot be reproduced in torch): the initial
directions from ``random_unit_vectors(key, R)``, then one ``split`` per
bounce of ``fold_in(key, 0xFACE)``.  ``stochastic.postprocess`` gets the
reference's uniforms and signs the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core import geometry as jg
from wayverb_tpu.core.attenuator import Microphone as JMicrophone
from wayverb_tpu.core.attenuator import Null as JNull
from wayverb_tpu.core.orientation import random_unit_vectors as j_ruv
from wayverb_tpu.core import pressure as jp
from wayverb_tpu.core import surfaces as jsf
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu.raytracer import histogram as jh
from wayverb_tpu.raytracer import stochastic as js
from wayverb_tpu.raytracer import tracer as jt
from wayverb_tpu.signal import multiband as jmb
from wayverb_tpu.signal import windows as jw
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core import geometry as tg
from wayverb_tpu_torch.core import pressure as tp
from wayverb_tpu_torch.core import surfaces as tsf
from wayverb_tpu_torch.core.attenuator import Microphone, Null
from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.raytracer import accel
from wayverb_tpu_torch.raytracer import histogram as th
from wayverb_tpu_torch.raytracer import stochastic as ts
from wayverb_tpu_torch.raytracer import tracer as tt
from wayverb_tpu_torch.signal import multiband as tmb
from wayverb_tpu_torch.signal import windows as tw

torch.set_num_threads(2)

BOX = jg.Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
SOURCE = (2.09, 2.12, 2.12)
RECEIVER = (2.09, 3.08, 0.96)
RAYS = 1024
MAX_TIME = 0.5
GEOM_RTOL = 8 * float(np.finfo(np.float32).eps)   # a few float32 ulps


def _soups():
    jsoup = jg.box_scene(BOX)
    return jsoup, convert.soup_from_numpy(
        np.asarray(jsoup.vertices), np.asarray(jsoup.triangles),
        np.asarray(jsoup.surfaces))


def _rays(rng, n):
    origins = rng.uniform([0.2, 0.2, 0.2], [5.3, 3.7, 2.6],
                          size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)) \
        .astype(np.float32)
    return origins, dirs


def test_geometry_matches(rng):
    """Normals, areas, mirroring, closest hits, line of sight, the segment–
    sphere test and the volume sum; a few float32 ulps."""
    jsoup, tsoup = _soups()
    o, d = _rays(rng, 512)
    close = lambda g, w: np.testing.assert_allclose(  # noqa: E731
        g.numpy(), np.asarray(w), rtol=GEOM_RTOL, atol=GEOM_RTOL)
    close(tg.triangle_normals(tsoup), jg.triangle_normals(jsoup))
    close(tg.triangle_areas(tsoup), jg.triangle_areas(jsoup))
    corners = np.asarray(jsoup.corners())[rng.integers(0, 12, 512)]
    close(tg.mirror_point(torch.from_numpy(o), torch.from_numpy(corners)),
          jg.mirror_point(jnp.asarray(o), jnp.asarray(corners)))
    exclude = rng.integers(-1, 12, 512)
    t_got, i_got, h_got = tg.scene_intersection(
        torch.from_numpy(o), torch.from_numpy(d), tsoup,
        torch.from_numpy(exclude))
    t_want, i_want, h_want = jg.scene_intersection(
        jnp.asarray(o), jnp.asarray(d), jsoup, jnp.asarray(exclude))
    assert np.array_equal(h_got.numpy(), np.asarray(h_want))
    assert np.array_equal(i_got.numpy(), np.asarray(i_want))
    close(t_got, t_want)
    ends = np.asarray(_rays(rng, 512)[0])
    assert np.array_equal(
        tg.line_of_sight(torch.from_numpy(o), torch.from_numpy(ends),
                         tsoup).numpy(),
        np.asarray(jg.line_of_sight(jnp.asarray(o), jnp.asarray(ends),
                                    jsoup)))
    centre = np.asarray(RECEIVER, np.float32)
    assert np.array_equal(
        tg.line_segment_sphere_intersection(
            torch.from_numpy(o), torch.from_numpy(ends),
            torch.from_numpy(centre), 0.5).numpy(),
        np.asarray(jg.line_segment_sphere_intersection(
            jnp.asarray(o), jnp.asarray(ends), jnp.asarray(centre), 0.5)))
    close(tg.tetrahedron_volume_sum(tsoup), jg.tetrahedron_volume_sum(jsoup))
    assert accel.auto_accel(tsoup, "cpu") is None


@pytest.mark.parametrize("name", ["sinc_kernel", "blackman", "hanning",
                                  "left_hanning", "right_hanning",
                                  "windowed_sinc_kernel"])
def test_windows_match(name):
    args = (0.2, 41) if "sinc" in name else (41,)
    np.testing.assert_allclose(getattr(tw, name)(*args).numpy(),
                               np.asarray(getattr(jw, name)(*args)),
                               rtol=1e-6, atol=1e-6)


def test_surface_and_pressure_conversions_match(rng):
    """The elementwise acoustics the ray leg and image sources use."""
    a = rng.uniform(0.01, 0.9, (5, 8)).astype(np.float32)
    s_ = rng.uniform(0.0, 1.0, (5, 8)).astype(np.float32)
    cos = rng.uniform(0.0, 1.0, (5, 8)).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    for name, args in [
            ("absorption_to_energy_reflectance", (a,)),
            ("absorption_to_pressure_reflectance", (a,)),
            ("pressure_reflectance_to_average_wall_impedance", (a,)),
            ("average_wall_impedance_to_pressure_reflectance", (1 / a, cos)),
            ("pressure_reflectance_at_angle", (a, cos)),
            ("scattered_pressure", (x, s_)),
            ("specular_pressure", (x, s_))]:
        np.testing.assert_allclose(
            getattr(tsf, name)(*map(torch.from_numpy, args)).numpy(),
            np.asarray(getattr(jsf, name)(*map(jnp.asarray, args))),
            rtol=1e-6, err_msg=name)
    for name, args in [("pressure_to_intensity", (x, 400.0)),
                       ("intensity_to_pressure", (x, 400.0)),
                       ("intensity_for_distance", (a + 1,)),
                       ("pressure_for_distance", (a + 1, 400.0))]:
        t_args = [torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for v in args]
        j_args = [jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for v in args]
        np.testing.assert_allclose(getattr(tp, name)(*t_args).numpy(),
                                   np.asarray(getattr(jp, name)(*j_args)),
                                   rtol=1e-6, err_msg=name)


def test_multiband_mixdown_matches(rng):
    """8 bands, each bandpassed to its own range and summed; 1e-5 of peak."""
    sig = rng.normal(size=(8, 3000)).astype(np.float32)
    want = np.asarray(jmb.multiband_filter_and_mixdown(jnp.asarray(sig),
                                                       16000.0))
    got = tmb.multiband_filter_and_mixdown(torch.from_numpy(sig), 16000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("width", [None, 8])
def test_histograms_match(rng, width):
    """Dirac and windowed-sinc deposits, including times whose sinc window
    starts before t = 0 (the reference wraps those indices to the end)."""
    times = rng.uniform(0.0, 0.05, 64).astype(np.float32)
    vols = rng.normal(size=(64, 8)).astype(np.float32)
    sr, bins = 16000.0, 900
    if width is None:
        got = th.dirac_histogram(torch.from_numpy(times),
                                 torch.from_numpy(vols), sr, bins)
        want = jh.dirac_histogram(jnp.asarray(times), jnp.asarray(vols), sr,
                                  bins)
    else:
        got = th.sinc_histogram(torch.from_numpy(times),
                                torch.from_numpy(vols), sr, bins, width)
        want = jh.sinc_histogram(jnp.asarray(times), jnp.asarray(vols), sr,
                                 bins, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def reference_directions(key, rays, depth):
    """The reference tracer's draws: initial (R, 3), per-bounce (D, R, 3)."""
    init = j_ruv(key, rays)
    k = jax.random.fold_in(key, 0xFACE)
    bounce = []
    for _ in range(depth):
        k, sub = jax.random.split(k)
        bounce.append(np.asarray(j_ruv(sub, rays)))
    return np.array(init), np.stack(bounce)


def reference_dirac_draws(key, n):
    """The reference's dirac-sequence draws: (uniforms, signs)."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (n,))),
            np.array(jax.random.rademacher(k2, (n,), dtype=jnp.float32)))


@pytest.fixture(scope="module")
def traces():
    jsoup, tsoup = _soups()
    jsurf = JSurface(absorption=jnp.full((1, 8), 0.1),
                     scattering=jnp.full((1, 8), 0.1))
    tsurf = convert.surface_from_numpy(np.full((1, 8), 0.1),
                                       np.full((1, 8), 0.1))
    depth = -(-jt.compute_optimum_reflection_number(0.1) // 8) * 8
    key = jax.random.PRNGKey(0)
    want = jt.trace_jit(jsoup, jsurf, SOURCE, RECEIVER, key, num_rays=RAYS,
                        depth=depth, max_time=MAX_TIME,
                        max_image_source_order=4)
    got = tt.trace_jit(tsoup, tsurf, SOURCE, RECEIVER, None, num_rays=RAYS,
                       depth=depth, max_time=MAX_TIME,
                       max_image_source_order=4,
                       directions=reference_directions(key, RAYS, depth))
    return got, want, depth


def test_trace_matches(traces):
    """Hit history equal on ≥ 99.9% of (bounce, ray) entries; the
    histogram's per-band totals within 1e-4 relative and its bin-wise L1
    difference ≤ 1e-3 of its total.  The reference pads depth to a power of
    two; its bounces past ``depth`` are all dead (-1)."""
    got, want, depth = traces
    jhist = np.asarray(want.triangle_history)
    assert np.all(jhist[depth:] == -1)
    agree = np.mean(got.triangle_history.numpy() == jhist[:depth])
    assert agree >= 0.999, agree
    g, w = got.histogram.numpy(), np.asarray(want.histogram)
    assert g.shape == w.shape == (501, 20, 9, 8)
    np.testing.assert_allclose(g.sum(axis=(0, 1, 2)), w.sum(axis=(0, 1, 2)),
                               rtol=1e-4)
    assert np.abs(g - w).sum() <= 1e-3 * np.abs(w).sum()
    assert got.max_time() == pytest.approx(want.max_time())


@pytest.mark.parametrize("method", ["null", "microphone"])
def test_stochastic_postprocess_matches(traces, method):
    """The late tail from the same histogram and the reference's dirac
    draws, within 1e-5 of its peak."""
    got_trace, want_trace, _ = traces
    hist = np.asarray(want_trace.histogram)
    env = Environment()
    key = jax.random.PRNGKey(7)
    sr, volume = 16000.0, 62.0
    n = int(np.ceil(hist.shape[0] / 1000.0 * sr))
    jm, tm = ((JNull(), Null()) if method == "null"
              else (JMicrophone(shape=0.5), Microphone(shape=0.5)))
    want = np.asarray(js.postprocess(jnp.asarray(hist), 1000.0, jm, volume,
                                     env, sr, key))
    got = ts.postprocess(torch.from_numpy(hist), 1000.0, tm, volume, env, sr,
                         draws=reference_dirac_draws(key, n))
    assert got.shape == want.shape == (n,)
    peak = np.abs(want).max()
    assert peak > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * peak)


def test_generator_draws_are_device_independent():
    """Generators of one seed give the same draws whatever the target
    device, so a card run and a CPU run can share them."""
    from wayverb_tpu_torch.core.orientation import random_unit_vectors
    a = random_unit_vectors(64, torch.Generator().manual_seed(5), "cpu")
    b = random_unit_vectors(64, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=-1).numpy(),
                               1.0, rtol=1e-6)
    u, s = ts.dirac_draws(100, torch.Generator().manual_seed(5), "cpu")
    assert u.shape == s.shape == (100,)
    assert set(s.tolist()) <= {-1.0, 1.0}


def test_capture_positions_match():
    """``trace(capture_positions=True)``: per-bounce reflection points,
    (depth, R, 3), within 1e-5 of the box's longest side (5.56 m) of the
    reference's over 8 bounces, on the rays whose triangle history agrees at
    every bounce (float32 rounding, which the reference's fused multiply-
    adds round otherwise, grows by about 2x every two bounces: 1.3e-5 m at
    bounce 8, 1.3e-4 m at bounce 16); a dead ray stays where it died.
    ``trace`` runs exactly ``depth`` bounces in both packages."""
    jsoup, tsoup = _soups()
    jsurf = JSurface(absorption=jnp.full((1, 8), 0.2),
                     scattering=jnp.full((1, 8), 0.3))
    tsurf = convert.surface_from_numpy(np.full((1, 8), 0.2),
                                       np.full((1, 8), 0.3))
    rays, depth = 256, 8
    key = jax.random.PRNGKey(3)
    want = jt.trace(jsoup, jsurf, SOURCE, RECEIVER, key, num_rays=rays,
                    depth=depth, max_time=MAX_TIME, capture_positions=True)
    got = tt.trace(tsoup, tsurf, SOURCE, RECEIVER, None, num_rays=rays,
                   depth=depth, max_time=MAX_TIME, capture_positions=True,
                   directions=reference_directions(key, rays, depth))
    assert tt.trace(tsoup, tsurf, SOURCE, RECEIVER, None, num_rays=rays,
                    depth=2, max_time=MAX_TIME).positions is None
    assert got.positions.shape == (depth, rays, 3)
    assert np.asarray(want.positions).shape == (depth, rays, 3)
    same = np.all(got.triangle_history.numpy()
                  == np.asarray(want.triangle_history), axis=0)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got.positions.numpy()[:, same],
                               np.asarray(want.positions)[:, same], rtol=0,
                               atol=1e-5 * 5.56)
    # every point lies on the box's walls
    p = got.positions.numpy()
    lo, hi = np.asarray(BOX.min_corner), np.asarray(BOX.max_corner)
    on_wall = np.min(np.minimum(np.abs(p - lo), np.abs(p - hi)), axis=-1)
    assert on_wall.max() <= 1e-5
    # a ray that dies keeps its last point
    hist = got.triangle_history.numpy()
    for b in range(1, depth):
        dead = hist[b] < 0
        np.testing.assert_array_equal(p[b][dead], p[b - 1][dead])


def test_three_vector_ops_are_the_cpus(rng):
    """The ray leg's three-vector reductions are elementwise ops in the
    order the CPU's library reductions use, so on the CPU they give the
    same bits as ``torch.sum`` / ``vector_norm`` / ``mean`` (and on the card
    the same bits as on the CPU: ``tests/test_torch_kernels.py``); the
    square root is the correctly rounded one (numpy's)."""
    a = torch.from_numpy(rng.normal(size=(100_000, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(100_000, 3)).astype(np.float32))
    assert torch.equal(tg.dot3(a, b), torch.sum(a * b, dim=-1))
    assert torch.equal(tg.sum3(a), torch.sum(a, dim=-1))
    assert torch.equal(tg.norm3(a), torch.linalg.vector_norm(a, dim=-1))
    x = a.abs().flatten()
    assert np.array_equal(tg.sqrt32(x).numpy(), np.sqrt(x.numpy()))
    # the tracer's mean scattering, band by band
    s = torch.from_numpy(rng.uniform(0, 1, size=(5, 8)).astype(np.float32))
    total = s[:, 0]
    for k in range(1, 8):
        total = total + s[:, k]
    assert torch.equal(total / 8, s.mean(dim=-1))
