"""The port's small host-side leaves against the JAX package, on the CPU:
``core.kernels`` (the excitation pulses within 1e-6 in float32, the
maximum-length sequence exactly), ``core.reverb`` (Sabine, Eyring, areas,
volume and air absorption within 1e-6 relative in float32) and
``waveguide.naive`` (the per-node oracle: equal to the reference's to the
bit on the same float64 inputs, and within 2e-5 of the port's plain general
step, the bound of the reference's own naive-against-stencil test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core import geometry as jg
from wayverb_tpu.core import kernels as jk
from wayverb_tpu.core import reverb as jr
from wayverb_tpu.waveguide import naive as jnaive
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core import kernels as tk
from wayverb_tpu_torch.core import reverb as tr
from wayverb_tpu_torch.core.geometry import Box, box_scene
from wayverb_tpu_torch.waveguide import naive as tnaive
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch.waveguide.setup import classify_boundaries
from wayverb_tpu_torch.waveguide.stencil import waveguide_step

torch.set_num_threads(2)

REL = 1e-6
FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("fc", [0.05, 0.1, 0.25])
def test_pulse_generators_match(fc):
    for name in ("gen_gaussian", "gen_sin_modulated_gaussian",
                 "gen_gaussian_dash", "gen_ricker"):
        _close(getattr(tk, name)(fc, device="cpu"), getattr(jk, name)(fc))
    t = np.linspace(-20.0, 20.0, 81, dtype=np.float32)
    for name, arg in (("gaussian", 3.0), ("sin_modulated_gaussian", 3.0),
                      ("gaussian_dash", 3.0), ("ricker", fc)):
        _close(getattr(tk, name)(torch.from_numpy(t), arg),
               getattr(jk, name)(jnp.asarray(t), arg))


@pytest.mark.parametrize("order", [2, 5, 8, 12])
def test_maximum_length_sequence_exact(order):
    got = tk.generate_maximum_length_sequence(order)
    want = jk.generate_maximum_length_sequence(order)
    assert got.dtype == want.dtype and got.shape == (2 ** order - 1,)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tk.generate_maximum_length_sequence(21)


def test_reverb_predictions_match():
    """Two materials on a box scene; per-band absorption."""
    box = ((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    jsoup = jg.box_scene(jg.Box(*box))
    surfaces = np.arange(12) % 2
    absorption = np.stack([np.linspace(0.05, 0.4, 8),
                           np.linspace(0.3, 0.1, 8)]).astype(np.float32)
    jsoup = jg.TriangleSoup(vertices=jsoup.vertices,
                            triangles=jsoup.triangles,
                            surfaces=jnp.asarray(surfaces, jnp.int32))
    tsoup = convert.soup_from_numpy(np.asarray(jsoup.vertices),
                                    np.asarray(jsoup.triangles), surfaces)
    a_t = tr.equivalent_absorption_area(tsoup, torch.from_numpy(absorption))
    a_j = jr.equivalent_absorption_area(jsoup, jnp.asarray(absorption))
    _close(a_t, a_j)
    v_t, v_j = tr.estimate_room_volume(tsoup), jr.estimate_room_volume(jsoup)
    s_t, s_j = tr.total_area(tsoup), jr.total_area(jsoup)
    _close(v_t, v_j)
    _close(s_t, s_j)
    air_t = tr.estimate_air_intensity_absorption(
        torch.tensor([125.0, 1000.0, 8000.0]), 50.0)
    air_j = jr.estimate_air_intensity_absorption(
        jnp.asarray([125.0, 1000.0, 8000.0]), 50.0)
    _close(air_t, air_j)
    _close(tr.sabine_reverb_time(v_t, a_t),
           jr.sabine_reverb_time(v_j, a_j))
    _close(tr.sabine_reverb_time(v_t, a_t, air_t[1]),
           jr.sabine_reverb_time(v_j, a_j, air_j[1]))
    _close(tr.eyring_reverb_time(v_t, a_t, s_t),
           jr.eyring_reverb_time(v_j, a_j, s_j))
    _close(tr.eyring_reverb_time(v_t, a_t, s_t, air_t[2]),
           jr.eyring_reverb_time(v_j, a_j, s_j, air_j[2]))
    # a medium room at 0.1: Sabine near 0.887 s (the reference's oracle)
    medium = box_scene(Box((0, 0, 0), (4.5, 2.5, 3.5)))
    t60 = tr.sabine_reverb_time(
        tr.estimate_room_volume(medium),
        tr.equivalent_absorption_area(medium, torch.full((1, 8), 0.1)))
    np.testing.assert_allclose(t60.numpy(), 0.887, rtol=5e-3)


def test_naive_step_matches_reference_and_plain_step():
    """Eight steps of a dirac in a 1.0 × 1.1 × 1.2 m box with fitted
    boundary filters (absorption 0.3): the port's naive oracle equals the
    reference's to the bit, and the port's plain general step (float32)
    stays within 2e-5 of it."""
    mesh = wgrun.shoebox_mesh(Box((0, 0, 0), (1.0, 1.1, 1.2)),
                              np.full((1, 8), 0.3), DX, FS, device="cpu")
    s = mesh.structure
    dims = mesh.descriptor.dimensions
    cat, inner = classify_boundaries(mesh.inside)
    slot_coef = np.zeros(dims + (3,), dtype=int)
    cb = s.coef_b.numpy().astype(np.float64)
    ca = s.coef_a.numpy().astype(np.float64)
    order = cb.shape[1] - 1
    src = tuple(np.asarray(dims) // 2)
    cur = np.zeros(dims)
    cur[src] = 1.0
    prev = np.zeros(dims)
    fmem_t = {loc: np.zeros((3, order)) for loc in np.ndindex(dims)}
    fmem_j = {loc: np.zeros((3, order)) for loc in np.ndindex(dims)}
    cur_t = torch.from_numpy(cur.astype(np.float32))
    prev_t = torch.zeros(dims)
    fstate = s.initial_filter_state()
    for _ in range(8):
        nxt = tnaive.naive_step(cur, prev, fmem_t, cat, inner, slot_coef, cb,
                                ca)
        want = jnaive.naive_step(cur, prev, fmem_j, cat, inner, slot_coef,
                                 cb, ca)
        np.testing.assert_array_equal(nxt, want)
        nxt_t, fstate = waveguide_step(cur_t, prev_t, fstate, s)
        np.testing.assert_allclose(nxt_t.numpy(), nxt, rtol=0, atol=2e-5)
        prev, cur = cur, nxt
        prev_t, cur_t = cur_t, nxt_t
    assert np.abs(cur).max() > 0
    assert all(np.array_equal(fmem_t[k], fmem_j[k]) for k in fmem_t)
