"""The port's multiband waveguide and time-domain filters against the JAX
reference, on the CPU.

``canonical_multiband`` runs one band at a time with flat boundaries at the
band's absorption; the reference vmaps the bands (its fused path) or loops
over them (``canonical``), and the port is held to both forms on the
shoebox of ``tests/test_waveguide.py``.  Then one general mesh (the B8
route on a card), one thin box (the B12 route) and the sharded shoebox of
``tests/test_sharding.py`` on two and four CPU shards, against the
reference's bands vmapped over two; the port runs one loop for every form
and ``use_vmap`` changes nothing.  Every
band's receiver output agrees within 2e-5 of its peak, the bound the other
waveguide parity tests use for XLA's fused multiply-adds (ROADMAP §C), and
its ``valid_hz`` is equal.  The reference's band edges come from the
absorption's band count, whatever the mesh rate; the port mirrors that.

The filters (``iir_filter``, ``filter_step``, ``biquad_cascade``,
``dc_blocker_coefficients``, ``rt60_measures``) are held to the oracles of
``tests/test_signal.py``, to a float64 recurrence (1e-12) and to the
reference in float32 (2e-5 of peak).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_general import _thin_meshes, port_soup
from wayverb_tpu.core import geometry as jgeo
from wayverb_tpu.parallel import sharding as jps
from wayverb_tpu.signal import filters as j_filters
from wayverb_tpu.signal import multiband as j_multiband
from wayverb_tpu.waveguide import descriptor as j_desc
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu_torch.core import geometry as tgeo
from wayverb_tpu_torch.parallel import sharding as tps
from wayverb_tpu_torch.signal import filters as t_filters
from wayverb_tpu_torch.waveguide import boundary as t_bdry
from wayverb_tpu_torch.waveguide import run as t_run

torch.set_num_threads(2)

FS = 3333.33
DX = j_desc.grid_spacing(340.0, 1.0 / FS)
REL = 2e-5
BOX = ((0.0, 0.0, 0.0), (1.0, 1.1, 1.2))
SRC, RCV = (0.5, 0.5, 0.5), (0.5, 0.5, 0.9)
ABSORPTION = np.tile(np.asarray([0.3, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]),
                     (1, 1))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


def _bands_match(got, want, stable=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.valid_hz == w.valid_hz
        assert g.sample_rate == pytest.approx(w.sample_rate)
        assert g.pressure.shape == tuple(np.shape(w.pressure))
        assert bool(g.stable) == stable
        _close(g.pressure, w.pressure)
        _close(g.intensity, w.intensity)


# ---------------------------------------------------------------------------
# the filters

def test_iir_impulse_response_matches_recurrence():
    """tests/test_signal.py's oracle; in float64 the port equals the direct
    recurrence to 1e-12, in float32 the reference to 2e-5 of peak."""
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.25]
    ref = np.zeros(64)
    xn = np.zeros(64)
    xn[0] = 1.0
    for n in range(64):
        acc = sum(b[i] * xn[n - i] for i in range(3) if n - i >= 0)
        acc -= sum(a[i] * ref[n - i] for i in range(1, 3) if n - i >= 0)
        ref[n] = acc
    y64, state = t_filters.iir_filter(torch.tensor(b, dtype=torch.float64),
                                      torch.tensor(a, dtype=torch.float64),
                                      torch.from_numpy(xn))
    assert y64.dtype == torch.float64 and state.shape == (2,)
    np.testing.assert_allclose(y64.numpy(), ref, rtol=0, atol=1e-12)
    want, want_state = j_filters.iir_filter(jnp.asarray(b), jnp.asarray(a),
                                            jnp.asarray(xn, jnp.float32))
    got, got_state = t_filters.iir_filter(torch.tensor(b), torch.tensor(a),
                                          torch.from_numpy(xn).float())
    _close(got, want)
    _close(got_state, want_state)


def test_filter_step_matches_scan(rng):
    b = torch.tensor([0.2, 0.3, 0.1, 0.05])
    a = torch.tensor([1.0, -0.4, 0.2, -0.1])
    x = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    y_scan, _ = t_filters.iir_filter(b, a, x)
    state = torch.zeros(3)
    ys = []
    for n in range(32):
        y, state = t_filters.filter_step(x[n], state, b, a)
        ys.append(float(y))
    np.testing.assert_allclose(ys, y_scan.numpy(), atol=1e-5)
    want, _ = j_filters.filter_step(jnp.asarray(x.numpy()[:4]),
                                    jnp.zeros((4, 3)), jnp.asarray(b.numpy()),
                                    jnp.asarray(a.numpy()))
    got, _ = t_filters.filter_step(x[:4], torch.zeros(4, 3), b, a)
    _close(got, want)


def test_dc_blocker_kills_dc():
    b, a = t_filters.dc_blocker_coefficients()
    jb, ja = j_filters.dc_blocker_coefficients()
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    y, _ = t_filters.iir_filter(b, a, torch.ones(2048))
    assert abs(float(y[-1])) < 1e-2


def test_biquad_cascade_and_gradients_match(rng):
    """Two sections over a batch of two signals; the gradient in the signal
    and in the coefficients against ``jax.grad``."""
    sb = np.asarray([[0.2, 0.3, 0.1], [0.5, -0.2, 0.05]], np.float32)
    sa = np.asarray([[1.0, -0.5, 0.25], [1.0, 0.3, 0.1]], np.float32)
    x = rng.normal(size=(2, 200)).astype(np.float32)
    want = j_filters.biquad_cascade(jnp.asarray(sb), jnp.asarray(sa),
                                    jnp.asarray(x))
    got = t_filters.biquad_cascade(torch.from_numpy(sb),
                                   torch.from_numpy(sa), torch.from_numpy(x))
    _close(got, want)

    def j_loss(b, a, sig):
        return jnp.sum(j_filters.iir_filter(b, a, sig)[0] ** 2)

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(sb[0]), jnp.asarray(sa[0]), jnp.asarray(x))
    tb, ta, tx = (torch.from_numpy(v.copy()).requires_grad_(True)
                  for v in (sb[0], sa[0], x))
    torch.sum(t_filters.iir_filter(tb, ta, tx)[0] ** 2).backward()
    for got_g, want_g in zip((tb.grad, ta.grad, tx.grad), jg):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=0,
                                   atol=1e-4 * float(np.abs(want_g).max()))
    # in float64 the analytic gradient equals the finite differences
    args = (torch.tensor(sb[1], dtype=torch.float64, requires_grad=True),
            torch.tensor(sa[1], dtype=torch.float64, requires_grad=True),
            torch.tensor(x[:, :12], dtype=torch.float64, requires_grad=True))
    assert torch.autograd.gradcheck(
        lambda b, a, s: t_filters.iir_filter(b, a, s)[0], args)


def test_rt60_measures_match():
    """EDT, T20 and T30 of a synthetic exponential of T60 0.7 s."""
    sr, t60 = 1000.0, 0.7
    t = np.arange(int(sr * 1.5)) / sr
    sig = np.power(10.0, -3.0 * t / t60).astype(np.float32)
    want = j_filters.rt60_measures(jnp.asarray(sig), sr)
    got = t_filters.rt60_measures(torch.from_numpy(sig), sr)
    assert set(got) == set(want) == {"edt", "t20", "t30"}
    for name in got:
        assert float(got[name]) == pytest.approx(float(want[name]), abs=1e-5)
        assert float(got[name]) == pytest.approx(t60, rel=0.05)


# ---------------------------------------------------------------------------
# canonical_multiband

@pytest.fixture(scope="module")
def shoebox():
    """tests/test_waveguide.py's multiband box through both of the
    reference's forms, 2 bands, 0.02 s."""
    jm = j_run.shoebox_mesh(jgeo.Box(*BOX), ABSORPTION, DX, FS)
    tm = t_run.shoebox_mesh(tgeo.Box(*BOX), ABSORPTION, DX, FS, device="cpu")
    np.testing.assert_array_equal(tm.inside, np.asarray(jm.inside))
    want = {v: j_run.canonical_multiband(jm, ABSORPTION, SRC, RCV, 0.02,
                                         num_bands=2, use_vmap=v)
            for v in (True, False)}
    return tm, want


@pytest.mark.parametrize("use_vmap", [True, False])
def test_canonical_multiband_shoebox_matches(shoebox, use_vmap):
    tm, want = shoebox
    got = t_run.canonical_multiband(tm, ABSORPTION, SRC, RCV, 0.02,
                                    num_bands=2, use_vmap=use_vmap)
    assert len(got) == 2 and got[0].valid_hz[1] == got[1].valid_hz[0]
    for form in (True, False):
        _bands_match(got, want[form])
    # a band is canonical on the mesh with its flat tables, and nothing
    # else of the mesh changes
    coef_b, coef_a = t_bdry.coefficient_table(
        [t_bdry.to_flat_coefficients(float(ABSORPTION[0, 1]))])
    structure = dataclasses.replace(tm.structure,
                                    coef_b=torch.from_numpy(coef_b),
                                    coef_a=torch.from_numpy(coef_a))
    band = t_run.canonical(dataclasses.replace(tm, structure=structure),
                           SRC, RCV, 0.02)
    assert torch.equal(got[1].pressure, band.pressure)
    assert torch.equal(got[1].intensity, band.intensity)


def test_band_edges_run_past_the_mesh(shoebox):
    """All 8 bands on a 3,333 Hz mesh: the band edges span 20 Hz – 20 kHz
    as in the reference, so the top bands lie above the mesh's Nyquist
    rate and the top edge is 20 kHz."""
    tm, _ = shoebox
    jm = j_run.shoebox_mesh(jgeo.Box(*BOX), ABSORPTION, DX, FS)
    want = j_run.canonical_multiband(jm, ABSORPTION, SRC, RCV, 0.003,
                                     num_bands=8, use_vmap=False)
    got = t_run.canonical_multiband(tm, ABSORPTION, SRC, RCV, 0.003,
                                    num_bands=8)
    _bands_match(got, want)
    assert got[-1].valid_hz[1] == pytest.approx(20000.0)
    assert got[-1].valid_hz[0] > got[0].sample_rate / 2
    for lo_band, hi_band in zip(got, got[1:]):
        assert lo_band.valid_hz[1] == hi_band.valid_hz[0]


@pytest.mark.parametrize("num_bands", range(1, 9))
def test_canonical_multiband_band_count(shoebox, num_bands):
    """Any band count from 1 to 8: the first ``num_bands`` hrtf bands of
    the absorption's band edges, each finite and stable and equal to the
    same band of the run over all eight (a band depends on its own
    absorption alone)."""
    tm, _ = shoebox
    edges = j_multiband.band_edges(8)
    got = t_run.canonical_multiband(tm, ABSORPTION, SRC, RCV, 0.003,
                                    num_bands=num_bands)
    every = t_run.canonical_multiband(tm, ABSORPTION, SRC, RCV, 0.003,
                                      num_bands=8)
    assert [g.valid_hz for g in got] == [
        (float(edges[b]), float(edges[b + 1])) for b in range(num_bands)]
    for g, e in zip(got, every):
        assert bool(g.stable) and bool(torch.isfinite(g.pressure).all())
        assert torch.equal(g.pressure, e.pressure)
        assert torch.equal(g.intensity, e.intensity)


def _rotated_soups(angle=0.42):
    """The rotated box of tests/test_general_fast.py as a scene for
    ``compute_mesh`` without ``scene_box``: a general mesh."""
    soup = jgeo.box_scene(jgeo.Box((0, 0, 0), (0.9, 0.8, 0.7)))
    c, s = np.cos(angle), np.sin(angle)
    rot = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    jsoup = jgeo.TriangleSoup(
        vertices=jnp.asarray(np.asarray(soup.vertices) @ rot.T),
        triangles=soup.triangles, surfaces=soup.surfaces)
    return jsoup, port_soup(jsoup)


GENERAL_SRC, GENERAL_RCV = (0.1, 0.5, 0.35), (0.3, 0.8, 0.3)


@pytest.fixture(scope="module")
def general_meshes():
    jsoup, tsoup = _rotated_soups()
    jm = j_run.compute_mesh(jsoup, ABSORPTION, DX, FS)
    tm = t_run.compute_mesh(tsoup, ABSORPTION, DX, FS, device="cpu")
    np.testing.assert_array_equal(tm.inside, np.asarray(jm.inside))
    assert tm.box_spec is None and tm.regions is None
    return jm, tm


def test_canonical_multiband_general_matches(general_meshes):
    jm, tm = general_meshes
    want = j_run.canonical_multiband(jm, ABSORPTION, GENERAL_SRC,
                                     GENERAL_RCV, 0.02, num_bands=2)
    got = t_run.canonical_multiband(tm, ABSORPTION, GENERAL_SRC, GENERAL_RCV,
                                    0.02, num_bands=2)
    _bands_match(got, want)


def test_canonical_multiband_thin_box_matches():
    jm, tm = _thin_meshes()
    assert tm.box_spec is None and tm.regions is not None
    src, rcv = (0.5, 0.6, 0.2), (0.9, 1.1, 0.3)
    ab = np.full((1, 8), 0.1)
    ab[0, 1] = 0.4
    want = j_run.canonical_multiband(jm, ab, src, rcv, 0.03, num_bands=2)
    got = t_run.canonical_multiband(tm, ab, src, rcv, 0.03, num_bands=2)
    _bands_match(got, want)


SHARD_BOX = ((0.0, 0.0, 0.0), (2.0, 2.5, 3.0))


@pytest.fixture(scope="module")
def aligned_shoebox():
    """tests/test_sharding.py's aligned mesh and its sharded multiband run
    (3 bands, vmapped inside shard_map over two virtual devices)."""
    absorption = np.linspace(0.05, 0.3, 8)[None, :]
    jm = j_run.compute_mesh(jgeo.box_scene(jgeo.Box(*SHARD_BOX)), absorption,
                            DX, FS, scene_box=jgeo.Box(*SHARD_BOX),
                            align=(8, 1, 1))
    tm = t_run.compute_mesh(tgeo.box_scene(tgeo.Box(*SHARD_BOX)), absorption,
                            DX, FS, scene_box=tgeo.Box(*SHARD_BOX),
                            align=(8, 1, 1), device="cpu")
    kw = dict(source_position=(1.0, 1.2, 1.5),
              receiver_position=(0.4, 1.9, 2.3), simulation_time=0.01,
              num_bands=3)
    want = j_run.canonical_multiband(jm, absorption, use_vmap=True,
                                     device_mesh=jps.make_device_mesh(2),
                                     **kw)
    return tm, absorption, kw, want


@pytest.mark.parametrize("shards", [2, 4])
def test_canonical_multiband_sharded_matches(aligned_shoebox, shards):
    """One ``canonical_sharded`` a band on ``["cpu"] * shards`` against the
    reference's sharded bands and the port's single-device bands."""
    tm, absorption, kw, want = aligned_shoebox
    got = t_run.canonical_multiband(
        tm, absorption,
        device_mesh=tps.make_device_mesh(shards, devices=["cpu"] * shards),
        **kw)
    _bands_match(got, want)
    single = t_run.canonical_multiband(tm, absorption, **kw)
    for g, s in zip(got, single):
        np.testing.assert_allclose(g.pressure.numpy(), s.pressure.numpy(),
                                   rtol=0, atol=2e-5)


def test_canonical_multiband_general_sharded_matches_single(general_meshes):
    """A general mesh over two CPU shards takes one
    ``canonical_general_sharded`` a band (B10 on a card) and equals the
    single-device bands."""
    jsoup, tsoup = _rotated_soups()
    tm = t_run.compute_mesh(tsoup, ABSORPTION, DX, FS, align=(2, 1, 1),
                            device="cpu")
    got = t_run.canonical_multiband(
        tm, ABSORPTION, GENERAL_SRC, GENERAL_RCV, 0.01, num_bands=2,
        device_mesh=tps.make_device_mesh(2, devices=["cpu"] * 2))
    single = t_run.canonical_multiband(tm, ABSORPTION, GENERAL_SRC,
                                       GENERAL_RCV, 0.01, num_bands=2)
    for g, s in zip(got, single):
        assert g.valid_hz == s.valid_hz and bool(g.stable)
        np.testing.assert_allclose(g.pressure.numpy(), s.pressure.numpy(),
                                   rtol=0, atol=1e-6)


def test_multiband_rt_orders_with_absorption():
    """The reference's decay-order oracle (tests/test_waveguide.py): a band
    with high absorption decays much faster than one with low."""
    box = tgeo.Box((0, 0, 0), (1.4, 1.5, 1.6))
    absorption = np.tile(np.asarray([0.6, 0.05, 0.05, 0.05,
                                     0.05, 0.05, 0.05, 0.05]), (1, 1))
    mesh = t_run.shoebox_mesh(box, absorption, DX, FS, device="cpu")
    bands = t_run.canonical_multiband(mesh, absorption, (0.7, 0.7, 0.5),
                                      (0.7, 0.7, 1.1), 0.12, num_bands=2)
    decays = []
    for b in bands:
        p = b.pressure.numpy()
        e = np.cumsum(p[::-1] ** 2)[::-1]
        e = e / e[0]
        idx = np.argmax(e < 1e-2)
        decays.append(idx if idx > 0 else len(e))
    assert decays[0] < 0.6 * decays[1], decays
