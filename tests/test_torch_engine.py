"""The port's hybrid engine end to end against the JAX engine, on the CPU.

``Engine.run`` + ``render`` on the ``test_combined.py`` box (cutoff 400 Hz,
1,024 rays, max_time 0.5 s, waveguide_time 0.25 s), with the reference's
random draws fed in: the tracer's directions and each render's dirac
uniforms and signs.  The rendered IRs have equal length and agree within
1e-3 of their peak; the bound allows the drift that XLA's fused multiply-
adds leave on long recurrences (ROADMAP §C), and a handful of rays whose hit
flips between two triangles of an edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_dirac_draws, reference_directions
from wayverb_tpu.combined import engine as jeng
from wayverb_tpu.combined import postprocess as jcp
from wayverb_tpu.core.attenuator import Hrtf as JHrtf
from wayverb_tpu.core.attenuator import Microphone as JMicrophone
from wayverb_tpu.core.attenuator import Null as JNull
from wayverb_tpu.core.geometry import Box as JBox, box_scene
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.combined import engine as teng
from wayverb_tpu_torch.combined import postprocess as tcp
from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
from wayverb_tpu_torch.core.geometry import Box as TBox

torch.set_num_threads(2)

BOX = ((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
SOURCE = (2.09, 2.12, 2.12)
RECEIVER = (2.09, 3.08, 0.96)
RAYS = 1024
SR = 16000.0
IR_REL = 1e-3


@pytest.fixture(scope="module")
def engines():
    jsoup = box_scene(JBox(*BOX))
    wparams = dict(cutoff=400.0, usable_portion=0.6)
    je = jeng.Engine(jsoup, JSurface(absorption=jnp.full((1, 8), 0.1),
                                     scattering=jnp.full((1, 8), 0.1)),
                     jeng.WaveguideParameters(**wparams),
                     scene_box=JBox(*BOX))
    te = teng.Engine(
        convert.soup_from_numpy(np.asarray(jsoup.vertices),
                                np.asarray(jsoup.triangles),
                                np.asarray(jsoup.surfaces)),
        convert.surface_from_numpy(np.full((1, 8), 0.1),
                                   np.full((1, 8), 0.1)),
        teng.WaveguideParameters(**wparams), scene_box=TBox(*BOX),
        device="cpu")
    key = jax.random.PRNGKey(0)
    jparams = jeng.RaytracerParameters(rays=RAYS, max_time=0.5)
    tparams = teng.RaytracerParameters(rays=RAYS, max_time=0.5)
    want = je.run(SOURCE, RECEIVER, key, jparams, waveguide_time=0.25)
    depth = teng.optimum_depth(te.surfaces)
    got = te.run(SOURCE, RECEIVER, None, tparams, waveguide_time=0.25,
                 directions=reference_directions(key, RAYS, depth))
    return want, got


def _tail_draws(results, key):
    n = int(np.ceil(results.stochastic_histogram.shape[0]
                    / results.histogram_sample_rate * SR))
    return reference_dirac_draws(key, n)


def test_run_matches(engines):
    """The raw results: waveguide band, histogram, image sources."""
    want, got = engines
    wb, gb = want.waveguide_bands[0], got.waveguide_bands[0]
    assert gb.pressure.shape == wb.pressure.shape == (667,)
    assert gb.sample_rate == wb.sample_rate and gb.valid_hz == wb.valid_hz
    np.testing.assert_allclose(gb.pressure.numpy(), np.asarray(wb.pressure),
                               rtol=0, atol=2e-5 * np.abs(wb.pressure).max())
    assert got.stochastic_histogram.shape == want.stochastic_histogram.shape
    assert got.room_volume == pytest.approx(want.room_volume)
    assert got.image_source.count == want.image_source.count
    np.testing.assert_allclose(got.image_source.distance.numpy(),
                               np.asarray(want.image_source.distance),
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["null", "microphone"])
def test_render_matches(engines, method):
    want, got = engines
    key = jax.random.PRNGKey(1)
    jm, tm = ((JNull(), Null()) if method == "null"
              else (JMicrophone(shape=0.5), Microphone(shape=0.5)))
    w = np.asarray(jeng.render(want, jm, SR, key))
    g = teng.render(got, tm, SR, draws=_tail_draws(got, key)).numpy()
    assert g.shape == w.shape
    peak = np.abs(w).max()
    assert np.all(np.isfinite(g)) and peak > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=IR_REL * peak)


def test_render_all_matches(engines):
    """Both capsules, jointly peak-normalised; the reference folds the key
    per capsule.  Then all four: omni, cardioid and the two ears."""
    want, got = engines
    key = jax.random.PRNGKey(2)
    w = np.asarray(jeng.render_all(want, [JNull(), JMicrophone(shape=0.5)],
                                   key, output_sample_rate=SR))
    draws = [_tail_draws(got, jax.random.fold_in(key, i)) for i in range(2)]
    g = teng.render_all(got, [Null(), Microphone(shape=0.5)],
                        output_sample_rate=SR, draws=draws).numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=IR_REL)
    # every capsule, both ears among them
    w = np.asarray(jeng.render_all(
        want, [JNull(), JMicrophone(shape=0.5), JHrtf(channel=0),
               JHrtf(channel=1)], key, output_sample_rate=SR))
    draws = [_tail_draws(got, jax.random.fold_in(key, i)) for i in range(4)]
    g = teng.render_all(got, [Null(), Microphone(shape=0.5), Hrtf(channel=0),
                              Hrtf(channel=1)],
                        output_sample_rate=SR, draws=draws).numpy()
    assert g.shape == w.shape and g.shape[0] == 4
    assert np.abs(g[2] - g[3]).max() > IR_REL
    np.testing.assert_allclose(g, w, rtol=0, atol=IR_REL)


@pytest.mark.parametrize("lengths", [(2048, 2048), (1500, 2300)])
def test_crossover_and_window_match(rng, lengths):
    """The crossover of signals of equal or unequal length, then the fade-in
    to the direct arrival; 1e-5 of peak."""
    low = rng.normal(size=lengths[0]).astype(np.float32)
    high = rng.normal(size=lengths[1]).astype(np.float32)
    want = jcp.crossover_filter(jnp.asarray(low), jnp.asarray(high),
                                500.0 / 8000.0)
    got = tcp.crossover_filter(torch.from_numpy(low), torch.from_numpy(high),
                               500.0 / 8000.0)
    want = np.asarray(jcp.window_direct_arrival(want, SOURCE, RECEIVER,
                                                8000.0, 340.0))
    got = tcp.window_direct_arrival(got, SOURCE, RECEIVER, 8000.0, 340.0)
    assert got.shape == want.shape == (max(lengths),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_unported_branches_raise(engines):
    """A ``device_mesh`` builds a mesh whose x dim divides over it (the
    sharded runs are ``tests/test_torch_sharding.py``'s).  ``bands=2``,
    which raised before the multiband waveguide was ported, matches the
    reference's ``Engine(bands=2)``: each band within 2e-5 of its peak,
    with equal ``valid_hz``."""
    _, got = engines
    box = TBox(*BOX)
    from wayverb_tpu_torch.core.geometry import box_scene as t_box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.parallel.sharding import make_device_mesh
    surf = Surface(absorption=torch.full((1, 8), 0.1),
                   scattering=torch.full((1, 8), 0.1))
    e = teng.Engine(t_box_scene(box), surf, scene_box=box,
                    device_mesh=make_device_mesh(3, devices=["cpu"] * 3),
                    device="cpu")
    assert e.mesh.descriptor.dimensions[0] % 3 == 0
    assert e.mesh.box_spec is not None and e.device_mesh.size == 3
    wparams = dict(cutoff=400.0, usable_portion=0.6, bands=2)
    je = jeng.Engine(box_scene(JBox(*BOX)),
                     JSurface(absorption=jnp.full((1, 8), 0.1),
                              scattering=jnp.full((1, 8), 0.1)),
                     jeng.WaveguideParameters(**wparams),
                     scene_box=JBox(*BOX))
    te = teng.Engine(t_box_scene(box), surf,
                     teng.WaveguideParameters(**wparams), scene_box=box,
                     device="cpu")
    key = jax.random.PRNGKey(0)
    depth = teng.optimum_depth(te.surfaces)
    want = je.run(SOURCE, RECEIVER, key, jeng.RaytracerParameters(
        rays=RAYS, max_time=0.5), waveguide_time=0.1)
    got = te.run(SOURCE, RECEIVER, None, teng.RaytracerParameters(
        rays=RAYS, max_time=0.5), waveguide_time=0.1,
        directions=reference_directions(key, RAYS, depth))
    assert len(got.waveguide_bands) == len(want.waveguide_bands) == 2
    for gb, wb in zip(got.waveguide_bands, want.waveguide_bands):
        assert gb.valid_hz == wb.valid_hz and bool(gb.stable)
        peak = np.abs(np.asarray(wb.pressure)).max()
        np.testing.assert_allclose(gb.pressure.numpy(),
                                   np.asarray(wb.pressure), rtol=0,
                                   atol=2e-5 * peak)


def test_engine_runs_on_the_card_by_default():
    """Without ``device=`` the engine is built on the card; on a machine
    with no GPU that raises rather than falling back to the CPU."""
    from wayverb_tpu_torch.core.geometry import box_scene as t_box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    box = TBox(*BOX)
    surf = Surface(absorption=torch.full((1, 8), 0.1),
                   scattering=torch.full((1, 8), 0.1))
    if torch.cuda.is_available():
        e = teng.Engine(t_box_scene(box), surf, scene_box=box)
        assert e.device.type == "cuda" and e.mesh.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teng.Engine(t_box_scene(box), surf, scene_box=box)
