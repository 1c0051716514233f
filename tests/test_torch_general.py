"""The port's general (arbitrary-geometry) waveguide against the JAX
reference, on the CPU: the plain versions of the three dense kernels against
the reference's Pallas kernels (interpreted) and jnp forms, the mesh setup,
the step, the run loops, the routing of ``execute`` and the hybrid engine on
a hall with columns.

Tolerances: kernels 1e-5 absolute (the bound ``tests/test_general_fast.py``
holds the Pallas kernels to); steps and runs 2e-5 per unit of peak (XLA
contracts a·b + c into FMAs inside a jitted scan, eager torch does not);
the rendered hybrid IR 1e-4 of its peak.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_dirac_draws, reference_directions
from wayverb_tpu.combined import engine as jeng
from wayverb_tpu.core import geometry as jgeo
from wayverb_tpu.core.attenuator import Null as JNull
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu.raytracer import scenes as jscenes
from wayverb_tpu.waveguide import box_boundary as jbb
from wayverb_tpu.waveguide import boundary as j_bdry
from wayverb_tpu.waveguide import descriptor as j_desc
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide import setup as j_setup
from wayverb_tpu.waveguide import stencil as j_stencil
from wayverb_tpu.waveguide import stencil_pallas as jsp
from wayverb_tpu.waveguide.receivers import NodeReceiver as JNodeReceiver
from wayverb_tpu.waveguide.sources import HardSource as JHardSource
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.combined import engine as teng
from wayverb_tpu_torch.core import geometry as tgeo
from wayverb_tpu_torch.core.attenuator import Null
from wayverb_tpu_torch.raytracer import scenes as tscenes
from wayverb_tpu_torch.waveguide import box_boundary as tbb
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import setup as t_setup
from wayverb_tpu_torch.waveguide import stencil as t_stencil
from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
from wayverb_tpu_torch.waveguide.sources import HardSource

torch.set_num_threads(2)

FS = 3333.33
DX = j_desc.grid_spacing(340.0, 1.0 / FS)
KERNEL_ATOL = 1e-5
RUN_REL = 2e-5
HALL_FS = 400.0 / (0.25 * 0.6)
HALL_DX = j_desc.grid_spacing(340.0, 1.0 / HALL_FS)
HALL_SRC, HALL_RCV = (6.0, 4.0, 5.0), (7.5, 3.0, 6.5)
TABLES = tuple(t_setup.GENERAL_TABLE_DTYPES)


def _close(got, want, rel=RUN_REL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=rel * max(1.0, float(np.abs(want).max())))


def rotated_box(absorption=0.25, angle=0.42):
    """The rotated box of ``tests/test_general_fast.py``: boundary nodes of
    every direction set plus reentrant nodes.  Returns the reference's
    (descriptor, soup, inside mask, structure)."""
    box = jgeo.Box((0, 0, 0), (0.9, 0.8, 0.7))
    soup = jgeo.box_scene(box)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    verts = np.asarray(soup.vertices) @ rot.T
    soup = jgeo.TriangleSoup(vertices=jnp.asarray(verts),
                             triangles=soup.triangles,
                             surfaces=soup.surfaces)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    adjusted = j_desc.compute_adjusted_boundary(
        jgeo.Box(tuple(lo), tuple(hi)), tuple((lo + hi) / 2), DX)
    desc = j_desc.descriptor_for_box(adjusted, DX)
    inside = j_setup.classify_inside_scene(desc, soup)
    coef_b, coef_a = j_bdry.coefficient_table(
        [j_bdry.compute_boundary_coefficients(np.full(8, absorption), FS)])
    structure = j_setup.build_structure(desc, inside, soup, coef_b, coef_a)
    return desc, soup, inside, structure


def port_soup(jsoup):
    return convert.soup_from_numpy(np.asarray(jsoup.vertices),
                                   np.asarray(jsoup.triangles),
                                   np.asarray(jsoup.surfaces))


def port_structure(js):
    """The reference structure's tables, carried across as numpy."""
    return t_setup.structure_from_numpy(
        np.asarray(js.coef_b), np.asarray(js.coef_a),
        {k: np.asarray(getattr(js, k)) for k in TABLES}, "cpu")


def mesh_dict(jm):
    """A reference mesh as the dictionary ``convert.mesh_from_numpy``
    takes."""
    d = {"min_corner": np.asarray(jm.descriptor.min_corner),
         "dimensions": np.asarray(jm.descriptor.dimensions),
         "spacing": jm.descriptor.spacing, "inside": np.asarray(jm.inside),
         "coef_b": np.asarray(jm.structure.coef_b),
         "coef_a": np.asarray(jm.structure.coef_a),
         "room_volume": jm.room_volume}
    d.update({k: np.asarray(getattr(jm.structure, k)) for k in TABLES})
    if jm.regions is not None:
        d["regions"] = [(r.start, r.size, r.inner_dirs, r.slot_coefs)
                        for r in jm.regions]
    return d


@pytest.fixture(scope="module")
def rotated():
    desc, soup, inside, js = rotated_box()
    return desc, soup, inside, js, port_structure(js)


def _kernel_case(dims, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda: rng.normal(size=dims).astype(np.float32)  # noqa: E731
    code = rng.integers(0, 1 << 13, size=dims).astype(np.int32)
    return f32(), f32(), code


# ---------------------------------------------------------------------------
# the three kernels' plain versions

def test_launch_geometries_refuse_what_their_kernels_cannot_cover():
    """Each family of mesh kernels refuses, before it builds or launches
    anything, the grids its own launch cannot cover: ``mesh_stencil.cuh``'s
    (⌈Z/128⌉, ⌈Y/2⌉, X) (B8, B12) and the x-walk's (⌈Y·Z/CTA⌉, ⌈X/walk⌉)
    with 32-bit node indices (B9, B11, and B10 since it walks x)."""
    assert tsk._stencil_geometry(343, 139, 259) is None
    for walk in (tsk.BWD_WALK, tsk.SHARD_BWD_WALK, tsk.SHARD_FWD_WALK):
        adjoint = tsk._adjoint_geometry(walk)
        assert adjoint(343, 139, 259) is None
        # x rows: one CTA row each, or one a walk
        assert tsk._stencil_geometry(65536, 1, 1) is not None
        assert adjoint(65536, 1, 1) is None
        assert adjoint(65535 * walk + 1, 1, 1) is not None
        # y rows: pairs of rows, or none (the (y, z) plane is flat)
        assert tsk._stencil_geometry(1, 131071, 1) is not None
        assert adjoint(1, 131071, 1) is None
        big = (2 ** 31 // (139 * 259) + 1, 139, 259)
        assert "32-bit" in adjoint(*big)
    g = torch.empty(big, device="meta")
    code = torch.empty(big, dtype=torch.int32, device="meta")
    adjoint = tsk._adjoint_geometry(tsk.BWD_WALK)
    with pytest.raises(ValueError, match="32-bit"):
        tsk._launch("weighted_step_bwd", "mesh_weighted_step_bwd",
                    "wv_mesh_weighted_step_bwd_f32", (g, code, g), adjoint)
    with pytest.raises(ValueError, match="empty"):
        tsk._launch("weighted_step_bwd", "mesh_weighted_step_bwd",
                    "wv_mesh_weighted_step_bwd_f32",
                    (g[:0], code[:0], g[:0]), adjoint)
    # B10: a walk of SHARD_FWD_WALK rows takes X = 65,536 with a small (Y, Z)
    # and refuses 2^31 nodes and ⌈X/walk⌉ > 65,535
    shard = tsk._adjoint_geometry(tsk.SHARD_FWD_WALK)
    assert tsk.SHARD_FWD_WALK >= 2
    assert shard(65536, 3, 5) is None
    assert shard(86, 139, 259) is None
    assert shard(65535 * tsk.SHARD_FWD_WALK + 1, 3, 5) is not None
    assert "32-bit" in shard(*big)
    halo = torch.empty((1, *big[1:]), device="meta")
    for dims, match in ((big, "32-bit"), ((65535 * tsk.SHARD_FWD_WALK + 1,
                                           1, 1), "launch geometry")):
        f = torch.empty(dims, device="meta")
        c = torch.empty(dims, dtype=torch.int32, device="meta")
        h = halo[:, :dims[1], :dims[2]]
        with pytest.raises(ValueError, match=match):
            tsk._launch("weighted_step_sharded", "mesh_weighted_step_haloed",
                        "wv_mesh_weighted_step_haloed_f32",
                        (f, f, c, h, h, f), shard)


@pytest.mark.parametrize("dims,against", [
    ((16, 8, 128), "jnp"), ((16, 8, 128), "pallas_interpret"),
    ((6, 7, 9), "jnp")])
def test_weighted_step_plain_matches_reference(dims, against):
    """B8's plain version against ``weighted_step_jnp`` and against the
    interpreted ``_wkernel``, random 13-bit codes."""
    cur, prev, code = _kernel_case(dims, 11)
    j = [jnp.asarray(a) for a in (cur, prev, code)]
    if against == "jnp":
        want = jsp.weighted_step_jnp(*j)
    else:
        want = jsp._wcall(jsp._wkernel, [(j[0], True), (j[1], False),
                                         (j[2], False)], True, *dims,
                          j[0].dtype)
    got = tsk.weighted_step(*(torch.from_numpy(a) for a in (cur, prev, code)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_weighted_step_out_buffer_may_be_previous():
    """``out=previous`` gives the same field and counts no launch on the
    CPU; ``out=current`` is refused on every device by the kernel's wrapper
    only, so here just the aliasing that the time loop uses."""
    cur, prev, code = (torch.from_numpy(a) for a in _kernel_case((6, 7, 9),
                                                                 4))
    want = tsk._weighted_step_plain(cur, prev, code)
    before = tsk.weighted_step.launches
    prev_buf = prev.clone()
    got = tsk.weighted_step(cur, prev_buf, code, out=prev_buf)
    assert got.data_ptr() == prev_buf.data_ptr()
    assert torch.equal(got, want)
    assert tsk.weighted_step.launches == before


@pytest.mark.parametrize("dims,against", [
    ((16, 8, 128), "pallas_interpret"), ((6, 7, 9), "jnp")])
def test_interior_step_plain_matches_reference(dims, against):
    """B12's plain version against ``interior_step_pallas(interpret=True)``
    and against ``stencil.interior_step``."""
    rng = np.random.default_rng(5)
    cur, prev = (rng.normal(size=dims).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=dims) > 0.3).astype(np.float32)
    j = [jnp.asarray(a) for a in (cur, prev, mask)]
    want = jsp.interior_step_pallas(*j, interpret=True) \
        if against == "pallas_interpret" else j_stencil.interior_step(*j)
    got = tsk.interior_step(*(torch.from_numpy(a) for a in (cur, prev, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


# ---------------------------------------------------------------------------
# setup

def test_build_structure_matches_on_rotated_box(rotated):
    """Every table of ``build_structure`` equals the reference's on the
    reference's inside mask; ``weight_code`` bit for bit."""
    desc, jsoup, inside, js, _ = rotated
    td = t_run.MeshDescriptor(desc.min_corner, desc.dimensions, desc.spacing)
    ts = t_setup.build_structure(td, np.asarray(inside), port_soup(jsoup),
                                 np.asarray(js.coef_b), np.asarray(js.coef_a),
                                 "cpu")
    assert ts.num_boundary_nodes == js.num_boundary_nodes > 0
    for name in TABLES:
        got = getattr(ts, name)
        assert got.dtype == t_setup.GENERAL_TABLE_DTYPES[name], name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.weight_code.dtype == torch.int32
    assert ts.initial_filter_state().shape == js.initial_filter_state().shape


def _small_hall():
    return jscenes.procedural_hall(2, 4, 1)[0]


@pytest.mark.parametrize("scene,backend", [
    ("rotated_box", "native"), ("rotated_box", "points_inside"),
    ("columns_hall", "native"), ("columns_hall", "points_inside")])
def test_classify_inside_scene_matches(scene, backend):
    """The inside mask against the reference's: the whole grid for the
    native vote and for ``points_inside`` on the rotated box; for
    ``points_inside`` on the columns hall the nodes of three grid planes
    that cut two columns.  Expect no differing node."""
    if scene == "rotated_box":
        desc, jsoup, want, _ = rotated_box()
    else:
        jsoup = _small_hall()
        aabb = jgeo.scene_aabb(jsoup)
        desc = j_desc.descriptor_for_box(j_desc.compute_adjusted_boundary(
            aabb, tuple(np.asarray(aabb.centre())), HALL_DX), HALL_DX)
        want = j_setup.classify_inside_scene(desc, jsoup)
    td = t_run.MeshDescriptor(desc.min_corner, desc.dimensions, desc.spacing)
    tsoup = port_soup(jsoup)
    if backend == "native" or scene == "rotated_box":
        got = t_setup.classify_inside_scene(td, tsoup,
                                            use_native=backend == "native")
        assert t_setup.classify_inside_scene.last_backend == backend
        assert int((got != np.asarray(want)).sum()) == 0
        assert 0 < got.sum() < got.size
        return
    planes = [desc.locator((0.0, 4.0, z))[2] for z in (6.14, 8.97, 12.0)]
    pos = desc.node_positions()[:, :, planes].reshape(-1, 3)
    got = tgeo.points_inside(torch.tensor(pos, dtype=torch.float32), tsoup)
    ref = np.asarray(jgeo.points_inside(jnp.asarray(pos, dtype=jnp.float32),
                                        jsoup))
    assert int((got.numpy() != ref).sum()) == 0
    assert int((got.numpy() != np.asarray(want)[:, :, planes].reshape(-1))
               .sum()) == 0


def test_procedural_hall_matches():
    for args in ((2, 4, 1), (3, 2, 2)):
        (js, jn), (ts, tn) = jscenes.procedural_hall(*args), \
            tscenes.procedural_hall(*args)
        assert jn == tn == ts.num_triangles
        for name in ("vertices", "triangles", "surfaces"):
            np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                          getattr(ts, name).numpy())
    assert tscenes.procedural_hall(2, 4, 1)[1] == 96


# ---------------------------------------------------------------------------
# the step

def test_waveguide_step_matches_reference(rotated):
    """Six steps on the rotated box from a random interior state: the
    port's fused step against its own gather oracle and against the
    reference's fused step, field and filter state, 2e-5."""
    desc, _, _, js, ts = rotated
    dims = desc.dimensions
    rng = np.random.default_rng(3)
    mask = np.asarray(js.interior_mask)
    cur = rng.normal(size=dims).astype(np.float32) * mask
    prev = rng.normal(size=dims).astype(np.float32) * mask
    jc, jp, jf = jnp.asarray(cur), jnp.asarray(prev), \
        js.initial_filter_state()
    tc, tp = torch.from_numpy(cur), torch.from_numpy(prev)
    tf = tf_ref = ts.initial_filter_state()
    for _ in range(6):
        jn, jf = j_stencil.waveguide_step(jc, jp, jf, js)
        tn, tf = t_stencil.waveguide_step(tc, tp, tf, ts)
        tn_ref, tf_ref = t_stencil.waveguide_step_reference(tc, tp, tf_ref,
                                                            ts)
        for got, want in ((tn, jn), (tf, jf), (tn_ref, jn), (tf_ref, jf)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=2e-5)
        jp, jc = jc, jn
        tp, tc = tc, tn


# ---------------------------------------------------------------------------
# the run loops

def _node_problem(js, dims, steps):
    """Hard impulse at an interior node, tap at its z neighbour, in both
    packages."""
    inside_locs = np.argwhere(np.asarray(js.interior_mask) > 0)
    src = int(np.ravel_multi_index(
        tuple(inside_locs[len(inside_locs) // 2]), dims))
    sig = np.zeros(steps, np.float32)
    sig[0] = 1.0
    jprob = (JHardSource(node_idx=jnp.asarray(src, dtype=jnp.int32),
                         signal=jnp.asarray(sig)),
             JNodeReceiver(node_idx=jnp.asarray(src + 1, dtype=jnp.int32)))
    tprob = (HardSource(node_idx=src, signal=torch.from_numpy(sig)),
             NodeReceiver(node_idx=torch.tensor(src + 1)))
    return jprob, tprob


@pytest.mark.parametrize("steps", [14, 60])
def test_run_waveguide_matches(rotated, steps):
    desc, _, _, js, ts = rotated
    dims = desc.dimensions
    jprob, tprob = _node_problem(js, dims, steps)
    want = j_run.run_waveguide(js, dims, *jprob, steps)
    before = tsk.weighted_step.launches
    got = t_run.run_waveguide(ts, dims, *tprob, steps)
    assert tsk.weighted_step.launches == before
    assert bool(got["stable"]) and bool(want["stable"])
    assert got["outputs"].shape == (steps,)
    assert float(np.abs(np.asarray(want["outputs"])).max()) > 0
    _close(got["outputs"], want["outputs"])


def test_run_waveguide_without_patch_tap_matches(rotated):
    """A source without ``patch_tap`` re-gathers the boundary's previous
    pressures each step; the outputs equal the carried form's."""
    desc, _, _, js, ts = rotated
    _, (source, receiver) = _node_problem(js, desc.dimensions, 20)

    @dataclasses.dataclass(frozen=True)
    class Plain:
        inner: HardSource

        def inject(self, field_flat, t):
            return self.inner.inject(field_flat, t)

    a = t_run.run_waveguide(ts, desc.dimensions, source, receiver, 20)
    b = t_run.run_waveguide(ts, desc.dimensions, Plain(source), receiver, 20)
    np.testing.assert_allclose(a["outputs"].numpy(), b["outputs"].numpy(),
                               rtol=0, atol=1e-6)


def test_run_waveguide_flags_nan(rotated):
    desc, _, _, js, ts = rotated
    _, (source, receiver) = _node_problem(js, desc.dimensions, 5)
    sig = source.signal.clone()
    sig[2] = float("nan")
    out = t_run.run_waveguide(ts, desc.dimensions,
                              dataclasses.replace(source, signal=sig),
                              receiver, 5)
    assert not bool(out["stable"])


THIN_BOX = ((0.0, 0.0, 0.0), (1.4, 1.6, 0.5))
THIN_SRC, THIN_RCV = (0.5, 0.6, 0.2), (0.9, 1.1, 0.3)


def _thin_meshes():
    """A box two nodes thin in z (the anchor sits half a spacing off the
    centre): too thin for the plane solver in both packages."""
    anchor = (0.7, 0.8, 0.25 + DX / 2)
    ab = np.full((1, 8), 0.1)
    jm = j_run.shoebox_mesh(jgeo.Box(*THIN_BOX), ab, DX, FS, anchor=anchor)
    tm = t_run.shoebox_mesh(tgeo.Box(*THIN_BOX), ab, DX, FS, anchor=anchor,
                            device="cpu")
    return jm, tm


def test_run_waveguide_regions_matches_on_thin_box():
    jm, tm = _thin_meshes()
    idx = np.argwhere(jm.inside)
    assert idx[:, 2].max() - idx[:, 2].min() == 1
    np.testing.assert_array_equal(jm.inside, tm.inside)
    assert jm.box_spec is None and tm.box_spec is None
    assert len(tm.regions) == len(jm.regions) == 26
    for jr, tr in zip(jm.regions, tm.regions):
        assert dataclasses.astuple(jr) == dataclasses.astuple(tr)
    dims = jm.descriptor.dimensions
    jprob, tprob = _node_problem(jm.structure, dims, 40)
    want = j_run.run_waveguide_regions(jm.structure, dims, *jprob, 40,
                                       tuple(jm.regions))
    got = t_run.run_waveguide_regions(tm.structure, dims, *tprob, 40,
                                      tm.regions)
    assert bool(got["stable"]) and bool(want["stable"])
    _close(got["outputs"], want["outputs"])
    # the region path against the general path on the same box
    gen = t_run.run_waveguide(tm.structure, dims, *tprob, 40)
    _close(gen["outputs"], want["outputs"])


def test_canonical_on_thin_box_matches():
    """A thin box no longer raises in ``execute``: it takes the region path,
    as in the reference, and ``canonical`` agrees."""
    jm, tm = _thin_meshes()
    want = j_run.canonical(jm, THIN_SRC, THIN_RCV, 0.03)
    before = tsk.interior_step.launches
    got = t_run.canonical(tm, THIN_SRC, THIN_RCV, 0.03)
    assert tsk.interior_step.launches == before
    assert bool(got.stable) and bool(want.stable)
    assert got.pressure.shape == np.asarray(want.pressure).shape == (100,)
    _close(got.pressure, want.pressure)
    _close(got.intensity, want.intensity)


@pytest.fixture(scope="module")
def hall_meshes():
    """The small columns hall (``procedural_hall(2, 4, 1)`` at a 400 Hz
    cutoff, spacing 0.22 m) meshed by both packages' ``compute_mesh``."""
    ab = np.full((1, 8), 0.1)
    jsoup = _small_hall()
    jm = j_run.compute_mesh(jsoup, ab, HALL_DX, HALL_FS)
    timings = {}
    tm = t_run.compute_mesh(tscenes.procedural_hall(2, 4, 1)[0], ab, HALL_DX,
                            HALL_FS, device="cpu", timings=timings)
    return jm, tm, timings


def test_compute_mesh_general_matches(hall_meshes):
    jm, tm, timings = hall_meshes
    assert dataclasses.astuple(jm.descriptor) == \
        dataclasses.astuple(tm.descriptor)
    assert int((jm.inside != tm.inside).sum()) == 0
    assert jm.room_volume == tm.room_volume
    assert tm.box_spec is None and tm.regions is None
    assert jm.box_spec is None and jm.regions is None
    for name in TABLES + ("coef_b", "coef_a"):
        np.testing.assert_array_equal(
            getattr(tm.structure, name).numpy(),
            np.asarray(getattr(jm.structure, name)), name)
    # reentrant nodes at the column edges: outside nodes that take the
    # interior update
    reentrant = (tm.structure.interior_mask.numpy() > 0) & ~tm.inside
    assert reentrant.sum() > 0
    assert timings["classifier"] in ("native", "points_inside")
    assert set(timings) == {"classify_s", "fit_s", "structure_s",
                            "classifier"}


def test_canonical_on_columns_hall_matches(hall_meshes):
    """``canonical`` on a general mesh: ``execute`` routes it to
    ``run_waveguide``; on the CPU no kernel launch is counted."""
    jm, tm, _ = hall_meshes
    sim = 99.5 / HALL_FS
    want = j_run.canonical(jm, HALL_SRC, HALL_RCV, sim)
    counters = (tsk.weighted_step, tsk.weighted_step_bwd, tsk.interior_step)
    before = [c.launches for c in counters]
    got = t_run.canonical(tm, HALL_SRC, HALL_RCV, sim)
    assert [c.launches for c in counters] == before
    assert bool(got.stable) and bool(want.stable)
    assert got.pressure.shape == (100,) and got.intensity.shape == (100, 3)
    assert got.sample_rate == want.sample_rate
    _close(got.pressure, want.pressure)
    _close(got.intensity, want.intensity)


def test_mesh_from_numpy_round_trip_general(hall_meshes):
    """A general mesh carried across as numpy runs as the port's own."""
    jm, tm, _ = hall_meshes
    carried = convert.mesh_from_numpy(mesh_dict(jm), "cpu")
    assert carried.box_spec is None and carried.regions is None
    assert carried.descriptor == tm.descriptor
    for name in TABLES:
        assert torch.equal(getattr(carried.structure, name),
                           getattr(tm.structure, name)), name
    sim = 19.5 / HALL_FS
    a = t_run.canonical(carried, HALL_SRC, HALL_RCV, sim)
    b = t_run.canonical(tm, HALL_SRC, HALL_RCV, sim)
    assert torch.equal(a.pressure, b.pressure)
    # regions cross too, and incomplete tables are refused
    jthin, tthin = _thin_meshes()
    thin = convert.mesh_from_numpy(mesh_dict(jthin), "cpu")
    assert thin.box_spec is None and thin.regions == tthin.regions
    d = mesh_dict(jm)
    del d["weight_code"]
    with pytest.raises(ValueError, match="all or none"):
        convert.mesh_from_numpy(d, "cpu")


# ---------------------------------------------------------------------------
# the slice as a whole

RAYS = 1024
SR = 16000.0


@pytest.fixture(scope="module")
def hall_engines():
    """Both engines on the small columns hall, without ``scene_box``, the
    reference's random draws fed to the port."""
    wparams = dict(cutoff=400.0, usable_portion=0.6)
    je = jeng.Engine(_small_hall(),
                     JSurface(absorption=jnp.full((1, 8), 0.1),
                              scattering=jnp.full((1, 8), 0.1)),
                     jeng.WaveguideParameters(**wparams))
    te = teng.Engine(tscenes.procedural_hall(2, 4, 1)[0],
                     convert.surface_from_numpy(np.full((1, 8), 0.1),
                                                np.full((1, 8), 0.1)),
                     teng.WaveguideParameters(**wparams), device="cpu")
    key = jax.random.PRNGKey(0)
    want = je.run(HALL_SRC, HALL_RCV, key,
                  jeng.RaytracerParameters(rays=RAYS, max_time=0.5),
                  waveguide_time=0.05)
    depth = teng.optimum_depth(te.surfaces)
    got = te.run(HALL_SRC, HALL_RCV, None,
                 teng.RaytracerParameters(rays=RAYS, max_time=0.5),
                 waveguide_time=0.05,
                 directions=reference_directions(key, RAYS, depth))
    return te, want, got


def test_engine_run_matches_on_columns_hall(hall_engines):
    te, want, got = hall_engines
    assert te.mesh.box_spec is None and te.mesh.regions is None
    assert te.ray_grid is None and te.soup.num_triangles == 96
    wb, gb = want.waveguide_bands[0], got.waveguide_bands[0]
    assert gb.pressure.shape == np.asarray(wb.pressure).shape
    assert gb.sample_rate == wb.sample_rate
    _close(gb.pressure, wb.pressure)
    assert got.room_volume == pytest.approx(want.room_volume)
    assert got.image_source.count == want.image_source.count
    assert got.stochastic_histogram.shape == want.stochastic_histogram.shape


def test_engine_render_matches_on_columns_hall(hall_engines):
    """The rendered IR within 1e-4 of its peak."""
    _, want, got = hall_engines
    key = jax.random.PRNGKey(1)
    w = np.asarray(jeng.render(want, JNull(), SR, key))
    n = int(np.ceil(got.stochastic_histogram.shape[0]
                    / got.histogram_sample_rate * SR))
    g = teng.render(got, Null(), SR,
                    draws=reference_dirac_draws(key, n)).numpy()
    assert g.shape == w.shape
    peak = np.abs(w).max()
    assert np.all(np.isfinite(g)) and peak > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * peak)


def test_region_tables_match():
    """``shoebox_regions`` and one ``region_step`` against the
    reference's."""
    inside = np.zeros((9, 8, 7), bool)
    inside[2:7, 2:6, 2:5] = True
    faces = [0, 1, 0, 1, 1, 0]
    jr, tr = jbb.shoebox_regions(inside, faces), \
        tbb.shoebox_regions(inside, faces)
    assert [dataclasses.astuple(r) for r in jr] == \
        [dataclasses.astuple(r) for r in tr]
    rng = np.random.default_rng(2)
    cur, prev = (rng.normal(size=inside.shape).astype(np.float32)
                 for _ in range(2))
    cb = rng.uniform(0.5, 1.5, size=(2, 7)).astype(np.float32)
    ca = rng.uniform(0.5, 1.5, size=(2, 7)).astype(np.float32)
    for k in (0, 9, 20):                        # a face, an edge, a corner
        st = rng.normal(size=jr[k].state_shape(6)).astype(np.float32)
        wp, ws = jbb.region_step(jnp.asarray(cur), jnp.asarray(prev),
                                 jnp.asarray(st), jr[k], jnp.asarray(cb),
                                 jnp.asarray(ca))
        gp, gs = tbb.region_step(torch.from_numpy(cur),
                                 torch.from_numpy(prev), torch.from_numpy(st),
                                 tr[k], torch.from_numpy(cb),
                                 torch.from_numpy(ca))
        _close(gp, wp, 1e-5)
        _close(gs, ws, 1e-5)
