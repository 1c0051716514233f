"""The port's source excitation design against the JAX package's
``waveguide.excitation``: every function on the same float64 inputs, within
1e-12 (absolute, and relative to each result's largest value)."""

import numpy as np
import pytest

from wayverb_tpu.waveguide import excitation as jexc
from wayverb_tpu_torch.waveguide import excitation as texc

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("steps", [8, 24, 32])
def test_mesh_impulse_response_and_window(steps):
    got = texc.mesh_impulse_response(steps)
    _close(got, jexc.mesh_impulse_response(steps))
    assert got[0] == 0.0 and np.abs(got[1:]).max() > 0
    _close(texc.right_hanning(steps), jexc.right_hanning(steps))


def test_make_transparent(rng):
    sig = rng.normal(size=20)
    _close(texc.make_transparent(sig, ir_steps=24),
           jexc.make_transparent(sig, ir_steps=24))


@pytest.mark.parametrize("t", [0, 1, 5, 6, 31, 32.0])
def test_factdbl(t):
    assert texc.factdbl(t) == jexc.factdbl(t)


@pytest.mark.parametrize("f0,n,amp,length", [(0.075, 16, 0.00025, 128),
                                             (0.1, 4, 1.0, 16)])
def test_maxflat(f0, n, amp, length):
    got, g_off = texc.maxflat(f0, n, amp, length)
    want, w_off = jexc.maxflat(f0, n, amp, length)
    assert g_off == w_off
    _close(got, want)


def test_pcs_pieces():
    args = (400.0, 340.0, 8000.0, 0.1)
    assert texc.compute_g0(*args) == pytest.approx(jexc.compute_g0(*args),
                                                   rel=TOL)
    for sphere in ((0.025, 100.0 / 8000.0, 0.7, 1 / 8000.0),
                   (0.05, 0.01, 1.2, 1 / 44100.0)):
        for got, want in zip(texc.mech_sphere(*sphere),
                             jexc.mech_sphere(*sphere)):
            _close(got, want)
    b, a = jexc.mech_sphere(0.025, 100.0 / 8000.0, 0.7, 1 / 8000.0)
    x = np.random.default_rng(3).normal(size=64)
    _close(texc._biquad_filter(b, a, x), jexc._biquad_filter(b, a, x))


@pytest.mark.parametrize("length,fs", [(1 << 10, 8000.0), (300, 44100.0)])
def test_design_pcs_source(length, fs):
    args = (length, 400.0, 340.0, fs, 0.1, 0.025, 100.0, 0.7)
    got, g_off = texc.design_pcs_source(*args)
    want, w_off = jexc.design_pcs_source(*args)
    assert g_off == w_off
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    _close(got, want)
