"""The port's image-source solvers against the JAX reference, on the CPU.

``tree`` takes the same (depth, R) hit history (from the JAX tracer) and
``exact`` the same shoebox; positions, distances and volumes agree to 1e-5
relative (the README's lattice row holds the lattice to 1e-3).
``postprocess`` renders the same impulses to an early IR for the omni,
cardioid and HRTF capsules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core import geometry as jg
from wayverb_tpu.core.attenuator import Hrtf as JHrtf
from wayverb_tpu.core.attenuator import Microphone as JMicrophone
from wayverb_tpu.core.attenuator import Null as JNull
from wayverb_tpu.core.impulse import Impulses as JImpulses
from wayverb_tpu.core.impulse import apply_distance_pressure as j_adp
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu.imagesource import exact as jex
from wayverb_tpu.imagesource import postprocess as jpp
from wayverb_tpu.imagesource import tree as jtree
from wayverb_tpu.raytracer import tracer as jt
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
from wayverb_tpu_torch.core.geometry import Box
from wayverb_tpu_torch.core.impulse import Impulses, apply_distance_pressure
from wayverb_tpu_torch.imagesource import exact as tex
from wayverb_tpu_torch.imagesource import postprocess as tpp
from wayverb_tpu_torch.imagesource import tree as ttree

torch.set_num_threads(2)

BOX = ((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
SOURCE = (2.09, 2.12, 2.12)
RECEIVER = (2.09, 3.08, 0.96)
RTOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def scene():
    jsoup = jg.box_scene(jg.Box(*BOX))
    tsoup = convert.soup_from_numpy(np.asarray(jsoup.vertices),
                                    np.asarray(jsoup.triangles),
                                    np.asarray(jsoup.surfaces))
    absorption = np.linspace(0.05, 0.4, 8)[None, :]
    scattering = np.full((1, 8), 0.1)
    jsurf = JSurface(jnp.asarray(absorption, jnp.float32),
                     jnp.asarray(scattering, jnp.float32))
    tsurf = convert.surface_from_numpy(absorption, scattering)
    history = jt.trace_jit(jsoup, jsurf, SOURCE, RECEIVER,
                           jax.random.PRNGKey(3), num_rays=2048, depth=8,
                           max_time=0.5).triangle_history
    return jsoup, tsoup, jsurf, tsurf, np.array(history)


def test_tree_matches(scene):
    """Path dedupe, validation and per-path pressure, order by order."""
    jsoup, tsoup, jsurf, tsurf, history = scene
    want_groups = jtree.collect_paths(history, 4)
    got_groups = ttree.collect_paths(torch.from_numpy(history), 4)
    assert sorted(got_groups) == sorted(want_groups) == [1, 2, 3, 4]
    for k in want_groups:
        assert np.array_equal(got_groups[k], want_groups[k])
        w = jtree.validate_paths(want_groups[k], jsoup, SOURCE, RECEIVER)
        g = ttree.validate_paths(got_groups[k], tsoup, SOURCE, RECEIVER)
        assert np.array_equal(g.valid, w.valid)
        assert np.array_equal(g.surfaces, w.surfaces)
        _close(g.image_position, w.image_position)
        _close(g.cos_angles, w.cos_angles)
    want = jtree.find_image_source_impulses(history, jsoup, jsurf, SOURCE,
                                            RECEIVER, max_order=4)
    got = ttree.find_image_source_impulses(torch.from_numpy(history), tsoup,
                                           tsurf, SOURCE, RECEIVER,
                                           max_order=4)
    assert got.count == want.count > 6
    for field in ("volume", "position", "distance"):
        _close(getattr(got, field), getattr(want, field))


def test_exact_matches():
    """The shoebox lattice within 30 m, and the direct path."""
    absorption = np.linspace(0.05, 0.4, 8).astype(np.float32)
    want = jex.find_impulses(jg.Box(*BOX), SOURCE, RECEIVER,
                             jnp.asarray(absorption), 30.0)
    got = tex.find_impulses(Box(*BOX), SOURCE, RECEIVER,
                            torch.from_numpy(absorption), 30.0)
    assert got.count == want.count
    for field in ("volume", "position", "distance"):
        _close(getattr(got, field), getattr(want, field))
    jsoup = jg.box_scene(jg.Box(*BOX))
    tsoup = convert.soup_from_numpy(np.asarray(jsoup.vertices),
                                    np.asarray(jsoup.triangles),
                                    np.asarray(jsoup.surfaces))
    jd = jex.get_direct(SOURCE, RECEIVER, jsoup)
    td = tex.get_direct(SOURCE, RECEIVER, tsoup)
    for field in ("volume", "position", "distance"):
        _close(getattr(td, field), getattr(jd, field))
    # an occluded direct path carries zero volume
    assert float(tex.get_direct(SOURCE, (9.0, 2.0, 1.0), tsoup)
                 .volume.abs().max()) == 0.0


@pytest.mark.parametrize("method", ["null", "microphone"])
def test_postprocess_matches(scene, method):
    """Impulses with 1/r applied → early IR at 16 kHz, within 1e-5 of its
    peak; the same length.  Then the same impulses heard by the right ear
    of an ``Hrtf()`` capsule: distances from the ear, gains per band."""
    jsoup, tsoup, jsurf, tsurf, history = scene
    j_imp = j_adp(jtree.find_image_source_impulses(
        history, jsoup, jsurf, SOURCE, RECEIVER, 4).concatenate(
            jex.get_direct(SOURCE, RECEIVER, jsoup)), 400.0)
    t_imp = Impulses(*(torch.from_numpy(np.array(getattr(j_imp, f)))
                       for f in ("volume", "position", "distance")))
    jm, tm = ((JNull(), Null()) if method == "null"
              else (JMicrophone(shape=0.5), Microphone(shape=0.5)))
    want = np.asarray(jpp.postprocess(j_imp, jm, RECEIVER, 340.0, 16000.0))
    got = tpp.postprocess(t_imp, tm, RECEIVER, 340.0, 16000.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    want = np.asarray(jpp.postprocess(j_imp, JHrtf(channel=1), RECEIVER,
                                      340.0, 16000.0))
    got = tpp.postprocess(t_imp, Hrtf(channel=1), RECEIVER, 340.0, 16000.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_apply_distance_pressure_matches(rng):
    vol = rng.uniform(0, 1, (20, 8)).astype(np.float32)
    pos = rng.normal(size=(20, 3)).astype(np.float32)
    dist = rng.uniform(0.5, 30, 20).astype(np.float32)
    want = j_adp(JImpulses(jnp.asarray(vol), jnp.asarray(pos),
                           jnp.asarray(dist)), 400.0)
    got = apply_distance_pressure(Impulses(torch.from_numpy(vol),
                                           torch.from_numpy(pos),
                                           torch.from_numpy(dist)), 400.0)
    _close(got.volume, want.volume)
