"""Parity of the PyTorch port's waveguide-leg leaves with the JAX reference.

The same inputs, made with numpy from a seed, go through ``wayverb_tpu`` and
``wayverb_tpu_torch`` on the CPU: descriptor, mesh setup and boundary
coefficient tables, IIR design, multiband magnitudes and zero-phase
filtering, resampling, decay times, capsules and the band postprocess.
Tolerance atol 1e-6 unless a test states otherwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core import attenuator as j_att
from wayverb_tpu.core import orientation as j_ori
from wayverb_tpu.core.geometry import Box as JBox
from wayverb_tpu.signal import filters as j_filters
from wayverb_tpu.signal import iir_design as j_iir
from wayverb_tpu.signal import multiband as j_mb
from wayverb_tpu.signal import resample as j_rs
from wayverb_tpu.waveguide import boundary as j_bdry
from wayverb_tpu.waveguide import descriptor as j_desc
from wayverb_tpu.waveguide import postprocess as j_post
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu_torch.core import attenuator as t_att
from wayverb_tpu_torch.core import orientation as t_ori
from wayverb_tpu_torch.core.geometry import Box as TBox
from wayverb_tpu_torch.signal import filters as t_filters
from wayverb_tpu_torch.signal import iir_design as t_iir
from wayverb_tpu_torch.signal import multiband as t_mb
from wayverb_tpu_torch.signal import resample as t_rs
from wayverb_tpu_torch.waveguide import boundary as t_bdry
from wayverb_tpu_torch.waveguide import descriptor as t_desc
from wayverb_tpu_torch.waveguide import postprocess as t_post
from wayverb_tpu_torch.waveguide import run as t_run

torch.set_num_threads(2)

FS = 3333.33
DX = j_desc.grid_spacing(340.0, 1.0 / FS)
ATOL = 1e-6
BOXES = [((0.0, 0.0, 0.0), (1.4, 1.6, 1.8)),
         ((0.3, -0.2, 0.1), (2.3, 2.3, 3.1))]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("lo,hi", BOXES)
def test_descriptor_matches(lo, hi):
    jb, tb = JBox(lo, hi), TBox(lo, hi)
    np.testing.assert_array_equal(np.asarray(jb.centre()),
                                  np.asarray(tb.centre()))
    anchor = tuple(np.asarray(jb.centre()))
    jd = j_desc.descriptor_for_box(
        j_desc.compute_adjusted_boundary(jb, anchor, DX), DX)
    td = t_desc.descriptor_for_box(
        t_desc.compute_adjusted_boundary(tb, anchor, DX), DX,
        align=t_desc.default_alignment())
    assert (jd.min_corner, jd.dimensions, jd.spacing) == \
        (td.min_corner, td.dimensions, td.spacing)
    assert jd.sample_rate(340.0) == td.sample_rate(340.0)
    rng = np.random.default_rng(7)
    pts = np.asarray(lo) + rng.uniform(size=(5, 3)) * \
        (np.asarray(hi) - np.asarray(lo))
    for p in pts:
        loc = jd.locator(p)
        np.testing.assert_array_equal(loc, td.locator(p))
        assert jd.flat_index(loc) == td.flat_index(loc)
        np.testing.assert_array_equal(jd.position(loc), td.position(loc))


@pytest.mark.parametrize("lo,hi", BOXES)
def test_shoebox_mesh_setup_matches(lo, hi):
    """Inside mask, box spec, volume, coefficient tables and every compact
    boundary table of ``build_structure`` agree exactly."""
    absorption = np.full((1, 8), 0.12)
    jm = j_run.shoebox_mesh(JBox(lo, hi), absorption, DX, FS)
    tm = t_run.shoebox_mesh(TBox(lo, hi), absorption, DX, FS, device="cpu")
    assert dataclasses.astuple(jm.descriptor) == \
        dataclasses.astuple(tm.descriptor)
    np.testing.assert_array_equal(jm.inside, tm.inside)
    assert (jm.box_spec.dims, jm.box_spec.ilo, jm.box_spec.ihi,
            jm.box_spec.face_surface) == (tm.box_spec.dims, tm.box_spec.ilo,
                                          tm.box_spec.ihi,
                                          tm.box_spec.face_surface)
    assert jm.room_volume == tm.room_volume
    for name in ("coef_b", "coef_a"):
        np.testing.assert_array_equal(np.asarray(getattr(jm.structure, name)),
                                      getattr(tm.structure, name).numpy())
    for name in ("interior_mask", "b_node_idx", "b_neighbor_idx",
                 "b_neighbor_w", "b_slot_mask", "b_slot_inner_idx",
                 "b_slot_coef", "weight_code"):
        np.testing.assert_array_equal(np.asarray(getattr(jm.structure, name)),
                                      getattr(tm.structure, name), name)


@pytest.mark.parametrize("absorption", [
    np.full(8, 0.1), np.asarray([0.05, 0.06, 0.08, 0.1, 0.15, 0.2, 0.3, 0.4]),
    np.full(8, 0.9)])
def test_boundary_coefficient_tables_match(absorption):
    jc = [j_bdry.compute_boundary_coefficients(absorption, FS),
          j_bdry.to_flat_coefficients(float(absorption[3]))]
    tc = [t_bdry.compute_boundary_coefficients(absorption, FS),
          t_bdry.to_flat_coefficients(float(absorption[3]))]
    for jt, tt in zip(j_bdry.coefficient_table(jc),
                      t_bdry.coefficient_table(tc)):
        _close(tt, jt)


def test_iir_design_matches():
    rng = np.random.default_rng(3)
    freqs = np.sort(rng.uniform(0.0, 1.0, size=9))
    mags = rng.uniform(0.2, 0.95, size=9)
    for kw in ({}, {"pin_edges_to_zero": False, "max_magnitude": 0.99}):
        jb, ja = j_iir.design_magnitude_filter(freqs, mags, 6, **kw)
        tb, ta = t_iir.design_magnitude_filter(freqs, mags, 6, **kw)
        _close(tb, jb)
        _close(ta, ja)
        assert j_iir.is_stable(ja) == t_iir.is_stable(ta)
        grid = np.linspace(0.0, 1.0, 64)
        _close(np.abs(t_iir.frequency_response(tb, ta, grid)),
               np.abs(j_iir.frequency_response(jb, ja, grid)))
    jb, ja = j_iir.yulewalk_design(freqs, mags, 6)
    tb, ta = t_iir.yulewalk_design(freqs, mags, 6)
    _close(tb, jb)
    _close(ta, ja)


def test_multiband_magnitudes_match():
    _close(t_mb.band_edges(8), j_mb.band_edges(8))
    _close(t_mb.band_centres(8), j_mb.band_centres(8))
    f = np.linspace(0.0, 0.5, 513).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    for l in (0, 2):
        _close(t_mb.compute_lopass_magnitude(tf, 0.2, 0.1, l),
               j_mb.compute_lopass_magnitude(jf, 0.2, 0.1, l))
        _close(t_mb.compute_hipass_magnitude(tf, 0.05, 0.9, l),
               j_mb.compute_hipass_magnitude(jf, 0.05, 0.9, l))
        _close(t_mb.compute_bandpass_magnitude(tf, 0.05, 0.3, 0.1, l),
               j_mb.compute_bandpass_magnitude(jf, 0.05, 0.3, 0.1, l))


def test_apply_zero_phase_magnitude_matches(rng):
    x = rng.normal(size=(2, 1000)).astype(np.float32)
    got = t_mb.apply_zero_phase_magnitude(
        torch.from_numpy(x),
        lambda f: t_mb.compute_bandpass_magnitude(f, 0.02, 0.2, 0.1))
    want = j_mb.apply_zero_phase_magnitude(
        jnp.asarray(x),
        lambda f: j_mb.compute_bandpass_magnitude(f, 0.02, 0.2, 0.1))
    _close(got, want)


@pytest.mark.parametrize("in_sr,out_sr", [(FS, 44100.0), (44100.0, FS)])
def test_resample_matches(rng, in_sr, out_sr):
    """atol 1e-6 per unit of the output's peak: float32 sums of 64 taps, and
    downsampling scales the output up by the rate ratio."""
    x = rng.normal(size=700).astype(np.float32)
    got = t_rs.resample(torch.from_numpy(x), in_sr, out_sr)
    want = np.asarray(j_rs.resample(jnp.asarray(x), in_sr, out_sr))
    assert got.shape == want.shape
    _close(got, want, atol=ATOL * max(1.0, np.abs(want).max()))


def test_decay_analysis_matches(rng):
    """Schroeder curve, line fit and T20/T30 of noisy exponential decays.

    T30 atol 1e-5 s: the dB curve comes from a float32 cumulative sum over
    2000 samples, whose summation order differs between XLA and torch."""
    n, fs = 2000, 2000.0
    t = np.arange(n) / fs
    sig = (rng.normal(size=(3, n)) * np.exp(-t * np.asarray(
        [[6.0], [9.0], [14.0]]))).astype(np.float32)
    js, ts = jnp.asarray(sig), torch.from_numpy(sig)
    curve_j = np.asarray(j_filters.schroeder_integral(js))
    _close(t_filters.schroeder_integral(ts), curve_j,
           atol=1e-6 * curve_j.max())
    x = np.linspace(0.0, 1.0, 50, dtype=np.float32)
    y = (3.0 * x - 2.0 + 0.01 * rng.normal(size=50)).astype(np.float32)
    for got, want in zip(
            t_filters.linear_regression(torch.from_numpy(x),
                                        torch.from_numpy(y)),
            j_filters.linear_regression(jnp.asarray(x), jnp.asarray(y))):
        _close(got, want)
    for lo, hi in ((-5.0, -25.0), (-5.0, -35.0)):
        _close(t_filters.decay_time(ts, fs, lo, hi),
               j_filters.decay_time(js, fs, lo, hi), atol=1e-5)


def test_capsules_match(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    ori = ((0.3, 0.2, 0.9), (0.0, 1.0, 0.0))
    jm = j_att.Microphone(j_ori.Orientation(*ori), 0.5)
    tm = t_att.Microphone(t_ori.Orientation(*ori), 0.5)
    _close(tm.attenuation(tv), jm.attenuation(jv))
    _close(t_att.Null().attenuation(tv), j_att.Null().attenuation(jv))
    for got, want in zip(t_ori.angle_lut_indices(tv[1:], 36, 17),
                         j_ori.angle_lut_indices(jv[1:], 36, 17)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capsule", ["null", "cardioid"])
def test_band_postprocess_matches(rng, capsule):
    n = 500
    p = rng.normal(size=n).astype(np.float32)
    inten = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    if capsule == "null":
        jmeth, tmeth = j_att.Null(), t_att.Null()
    else:
        jmeth = j_att.Microphone(j_ori.Orientation((0.0, 0.0, 1.0)), 0.5)
        tmeth = t_att.Microphone(t_ori.Orientation((0.0, 0.0, 1.0)), 0.5)
    valid = (0.0, 500.0)
    want = j_post.postprocess(
        [j_post.BandpassBand(jnp.asarray(p), jnp.asarray(inten), FS, valid)],
        jmeth, 400.0, 44100.0)
    got = t_post.postprocess(
        [t_post.BandpassBand(torch.from_numpy(p), torch.from_numpy(inten),
                             FS, valid)], tmeth, 400.0, 44100.0)
    assert got.shape == want.shape
    _close(got, want)
