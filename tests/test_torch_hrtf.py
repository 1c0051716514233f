"""The port's HRTF capsule against the JAX reference, on the CPU.

The default Brown–Duda table (equal to the bit), ``table_from_energies``,
``Hrtf.attenuation`` and ``ear_position`` for both ears under a rotated
head, and every place a capsule reaches: the image-source ``attenuate``
(volumes and distances from the ear, 1e-6) and its early IR, the
stochastic tail's ``attenuate_histogram`` (a 24 × 9 table over the 20 × 9
histogram, 1e-5 relative) and the waveguide band postprocess, whose
(T, bands) HRTF signal is mixed down at the mesh rate (1e-5 of peak).  The
same inputs, made with numpy from a seed, go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core import attenuator as j_att
from wayverb_tpu.core import hrtf as j_hrtf
from wayverb_tpu.core import orientation as j_ori
from wayverb_tpu.core.impulse import Impulses as JImpulses
from wayverb_tpu.imagesource import postprocess as j_is
from wayverb_tpu.raytracer import stochastic as j_st
from wayverb_tpu.waveguide import postprocess as j_wg
from wayverb_tpu_torch.core import attenuator as t_att
from wayverb_tpu_torch.core import hrtf as t_hrtf
from wayverb_tpu_torch.core import orientation as t_ori
from wayverb_tpu_torch.core.impulse import Impulses
from wayverb_tpu_torch.imagesource import postprocess as t_is
from wayverb_tpu_torch.raytracer import stochastic as t_st
from wayverb_tpu_torch.waveguide import postprocess as t_wg

torch.set_num_threads(2)

ORIENTATION = ((0.3, 0.2, 0.9), (0.1, 1.0, 0.0))
RECEIVER = (2.09, 3.08, 0.96)
ATOL = 1e-6


def _capsules(channel, table=None, orientation=ORIENTATION):
    jt = None if table is None else jnp.asarray(table)
    return (j_att.Hrtf(j_ori.Orientation(*orientation), channel, 0.1, jt),
            t_att.Hrtf(t_ori.Orientation(*orientation), channel, 0.1, table))


def _directions(rng, n):
    """n random directions of random lengths, the first a zero vector."""
    v = (rng.normal(size=(n, 3)) * rng.uniform(0.1, 10.0, (n, 1))) \
        .astype(np.float32)
    v[0] = 0.0
    return v


def test_default_table_matches():
    want = np.asarray(j_hrtf.default_hrtf_table())
    got = t_hrtf.default_hrtf_table()
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (
        t_hrtf.NUM_AZ, t_hrtf.NUM_EL, t_hrtf.NUM_CHANNELS, t_hrtf.NUM_BANDS)
    assert float(np.abs(got.numpy() - want).max()) == 0.0


def test_table_from_energies_matches(rng):
    energies = rng.uniform(0.0, 2.0, (12, 5, 2, 8))
    want = np.asarray(j_hrtf.table_from_energies(energies))
    for given in (energies, energies.tolist(), torch.from_numpy(energies)):
        got = t_hrtf.table_from_energies(given)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    for bad in (np.ones((12, 5, 8)), np.ones((12, 5, 3, 8))):
        with pytest.raises(ValueError):
            j_hrtf.table_from_energies(bad)
        with pytest.raises(ValueError, match="table"):
            t_hrtf.table_from_energies(bad)


# the three Brown–Duda properties of tests/test_core.py, on the port's table

def test_dfe_unit_diffuse_average():
    t = t_hrtf.default_hrtf_table().numpy()
    el = (np.arange(t_hrtf.NUM_EL) - t_hrtf.NUM_EL // 2) * (
        np.pi / t_hrtf.NUM_EL)
    w = np.cos(el)[None, :, None, None]
    avg = (t * w).sum((0, 1)) / (t_hrtf.NUM_AZ * w.sum((0, 1)))
    np.testing.assert_allclose(avg, 1.0, rtol=1e-5)


def test_ild_monotone_with_frequency():
    """A hard-right source's right/left energy ratio grows with band
    frequency and exceeds ~3 dB by the top band."""
    t = t_hrtf.default_hrtf_table().numpy()
    ai = t_hrtf.NUM_AZ // 4          # az = 90 deg = +x = right
    mid = t_hrtf.NUM_EL // 2
    ild = t[ai, mid, 1] / np.maximum(t[ai, mid, 0], 1e-12)
    assert ild[0] < 1.1
    assert ild[-1] > 2.0
    assert np.all(np.diff(np.log(ild[:5])) > -1e-6)


def test_pinna_notches_elevation_dependent():
    t = t_hrtf.default_hrtf_table().numpy()
    front = t[0, :, 1, -2]           # az = 0 column over elevations
    assert front.max() / max(front.min(), 1e-12) > 1.2


@pytest.mark.parametrize("channel", [0, 1])
@pytest.mark.parametrize("table", ["default", "baked"])
def test_attenuation_and_ear_position_match(rng, channel, table):
    """Per-band gains of 4,096 directions (a zero vector among them) under
    a rotated head, with the default table and with a baked 12 × 5 one;
    the ear moved along the head's x axis."""
    energies = None if table == "default" else \
        rng.uniform(0.0, 2.0, (12, 5, 2, 8)).astype(np.float32)
    jh, th = _capsules(channel, energies)
    v = _directions(rng, 4096)
    want = np.asarray(jh.attenuation(jnp.asarray(v)))
    got = th.attenuation(torch.from_numpy(v))
    assert got.shape == want.shape == (4096, 8)
    assert got.dtype == torch.float32
    assert float(got[0].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    base = np.asarray(RECEIVER, np.float32)
    want_ear = np.asarray(jh.ear_position(jnp.asarray(base)))
    for given in (RECEIVER, torch.from_numpy(base)):
        ear = th.ear_position(given)
        assert ear.dtype == torch.float32 and ear.device.type == "cpu"
        np.testing.assert_allclose(ear.numpy(), want_ear, rtol=0, atol=ATOL)
    assert float(np.linalg.norm(want_ear - base)) == pytest.approx(0.1)


def _impulses(rng, n=300):
    vol = rng.uniform(0.0, 1.0, (n, 8)).astype(np.float32)
    pos = (np.asarray(RECEIVER) + rng.normal(size=(n, 3)) * 6.0) \
        .astype(np.float32)
    dist = np.linalg.norm(pos - np.asarray(RECEIVER), axis=-1) \
        .astype(np.float32)
    return (JImpulses(jnp.asarray(vol), jnp.asarray(pos), jnp.asarray(dist)),
            Impulses(torch.from_numpy(vol), torch.from_numpy(pos),
                     torch.from_numpy(dist)))


@pytest.mark.parametrize("channel", [0, 1])
def test_image_source_attenuate_matches(rng, channel):
    """Volumes (N, bands) and the distances, now from the ear: the arrival
    times move, so both are compared."""
    jh, th = _capsules(channel)
    j_imp, t_imp = _impulses(rng)
    want_v, want_d = j_is.attenuate(jh, RECEIVER, j_imp)
    got_v, got_d = t_is.attenuate(th, RECEIVER, t_imp)
    assert got_v.shape == tuple(want_v.shape) == (300, 8)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=ATOL,
                               atol=ATOL)
    # the ear is off the centre, so the distances moved
    assert float((got_d - t_imp.distance).abs().max()) > 1e-3


@pytest.mark.parametrize("channel", [0, 1])
def test_image_source_postprocess_matches(rng, channel):
    jh, th = _capsules(channel)
    j_imp, t_imp = _impulses(rng)
    want = np.asarray(j_is.postprocess(j_imp, jh, RECEIVER, 340.0, 16000.0))
    got = t_is.postprocess(t_imp, th, RECEIVER, 340.0, 16000.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("channel", [0, 1])
def test_attenuate_histogram_matches(rng, channel):
    """The 24 × 9 table read at the centres of the 20 × 9 histogram's
    direction bins."""
    hist = rng.uniform(0.0, 1.0, (50, 20, 9, 8)).astype(np.float32)
    jh, th = _capsules(channel)
    want = np.asarray(j_st.attenuate_histogram(jnp.asarray(hist), jh))
    got = t_st.attenuate_histogram(torch.from_numpy(hist), th)
    assert got.shape == want.shape == (50, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("channel", [0, 1])
def test_waveguide_postprocess_matches(rng, channel):
    """Two bands of a 3,333 Hz mesh: each band's (T, 8) HRTF signal mixed
    down at the mesh rate, resampled to 16 kHz, bandpassed and summed."""
    n, fs = 400, 3333.33
    jh, th = _capsules(channel)
    jb, tb = [], []
    for valid in ((20.0, 47.43), (47.43, 112.47)):
        p = rng.normal(size=n).astype(np.float32)
        inten = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
        jb.append(j_wg.BandpassBand(jnp.asarray(p), jnp.asarray(inten), fs,
                                    valid))
        tb.append(t_wg.BandpassBand(torch.from_numpy(p),
                                    torch.from_numpy(inten), fs, valid))
    assert t_wg.attenuate(th, 400.0, tb[0].intensity,
                          tb[0].pressure).shape == (n, 8)
    want = np.asarray(j_wg.postprocess(jb, jh, 400.0, 16000.0))
    got = t_wg.postprocess(tb, th, 400.0, 16000.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
