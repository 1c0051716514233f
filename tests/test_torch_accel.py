"""The port's ray acceleration against the JAX reference, on the CPU.

Scenes are small procedural halls (a few hundred triangles); rays come from a
seeded numpy generator and go to both packages.  The reference's Pallas
kernels run in interpret mode, as its own tests run them.  Tolerances: XLA's
CPU backend contracts multiply-adds, so a t agrees to rtol 1e-5; hit masks
are equal; triangle ids are equal except where two triangles of a ray lie
within that tolerance of each other (a shared edge or a duplicated
triangle), which each test counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raytracer import reference_directions
from wayverb_tpu.core import geometry as jg
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu.imagesource import tree as jtree
from wayverb_tpu.raytracer import accel as jaccel
from wayverb_tpu.raytracer import mt_pallas as jmt
from wayverb_tpu.raytracer import scenes as jscenes
from wayverb_tpu.raytracer import tracer as jt
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core import geometry as tg
from wayverb_tpu_torch.imagesource import tree as ttree
from wayverb_tpu_torch.raytracer import accel as taccel
from wayverb_tpu_torch.raytracer import mt_kernels as tmt
from wayverb_tpu_torch.raytracer import scenes as tscenes
from wayverb_tpu_torch.raytracer import tracer as tt

torch.set_num_threads(2)

SIZE = np.asarray([20.0, 8.0, 15.0])
T_RTOL = 1e-5
BOX = ((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
MT_FIELDS = ("packed", "tile_boxes", "perm", "inv_perm", "scene_lo",
             "scene_inv_ext")


def _halls(*args):
    """The same procedural hall in both packages."""
    return jscenes.procedural_hall(*args)[0], \
        tscenes.procedural_hall(*args)[0]


def _rays(seed, n, num_triangles=None):
    """Origins inside the hall, unit directions, and (with a triangle count)
    a random exclude list."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(0.1, 0.9, (n, 3)) * SIZE).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if num_triangles is None:
        return o, d
    return o, d, rng.integers(-1, num_triangles, n).astype(np.int32)


def _carried(jtris):
    """The reference's packed triangles as the port's, table for table."""
    fields = {f: None if getattr(jtris, f) is None
              else np.asarray(getattr(jtris, f)) for f in MT_FIELDS}
    return convert.mt_triangles_from_numpy(num=jtris.num, **fields)


def _pair_t(o, d, packed, ids):
    """Float64 Möller–Trumbore t of ray r against triangle ids[r]."""
    p = np.asarray(packed, np.float64)[:, ids]
    v0, e1, e2 = p[0:3].T, p[3:6].T, p[6:9].T
    o, d = o.astype(np.float64), d.astype(np.float64)
    pv = np.cross(d, e2)
    inv = 1.0 / np.sum(e1 * pv, axis=-1)
    qv = np.cross(o - v0, e1)
    return np.sum(e2 * qv, axis=-1) * inv


def _assert_closest(got, want, o, d, packed, big=tmt.BIG):
    """(t, id) of two closest-hit results on the same packed triangles: hit
    masks equal, t within T_RTOL, ids equal except at ties within T_RTOL.
    Returns the number of such ties."""
    (gt, gi), (wt, wi) = [(np.asarray(t), np.asarray(i)) for t, i in
                          (got, want)]
    hit = wt < big
    assert np.array_equal(gt < big, hit)
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=T_RTOL)
    assert np.array_equal(gi[~hit], wi[~hit])       # a miss carries id 0
    differ = np.nonzero(hit & (gi != wi))[0]
    if len(differ):
        ta = _pair_t(o[differ], d[differ], packed, gi[differ])
        tb = _pair_t(o[differ], d[differ], packed, wi[differ])
        np.testing.assert_allclose(ta, tb, rtol=2 * T_RTOL)
    return len(differ)


# ---------------------------------------------------------------------------
# the tables

def test_ray_grid_tables_equal():
    jsoup, tsoup = _halls(8, 3, 2)
    for resolution in (None, 5):
        jgrid = jaccel.build_ray_grid(jsoup, resolution)
        tgrid = taccel.build_ray_grid(tsoup, resolution)
        assert tgrid.res == jgrid.res
        assert tgrid.max_per_cell == jgrid.max_per_cell
        for f in ("cells", "lo", "voxel"):
            want = np.asarray(getattr(jgrid, f))
            got = getattr(tgrid, f).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    carried = convert.ray_grid_from_numpy(
        np.asarray(jgrid.cells), np.asarray(jgrid.lo),
        np.asarray(jgrid.voxel), jgrid.res)
    assert carried.res == tgrid.res
    assert torch.equal(carried.cells, tgrid.cells)
    assert torch.equal(carried.voxel, tgrid.voxel)


@pytest.mark.parametrize("cull", [False, True])
def test_mt_tables_equal(cull):
    jsoup, tsoup = _halls(8, 3, 2)
    jtris = jmt.build_pallas_triangles(jsoup, cull=cull)
    ttris = tmt.build_mt_triangles(tsoup, cull=cull)
    assert ttris.num == jtris.num == 912 and ttris.culled == cull
    assert ttris.packed.shape == (9, tmt.TB)
    for f in MT_FIELDS:
        want = getattr(jtris, f)
        got = getattr(ttris, f)
        if want is None:
            assert got is None, f
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, f
        assert np.array_equal(got.numpy(), want), f
        assert torch.equal(getattr(_carried(jtris), f), got), f
    assert tmt.CULL_MIN_TRIS == jmt.CULL_MIN_TRIS
    assert (tmt.RB, tmt.TB, tmt.BIG) == (jmt.RB, jmt.TB, jmt.BIG)
    # the default culls only above CULL_MIN_TRIS
    assert not tmt.build_mt_triangles(tsoup).culled


def test_ray_sort_keys_equal():
    jsoup, tsoup = _halls(6, 2, 2)
    jtris = jmt.build_pallas_triangles(jsoup, cull=True)
    ttris = tmt.build_mt_triangles(tsoup, cull=True)
    o, d = _rays(11, 1024)
    o[:8] += 30.0                 # origins outside the scene clip to the edge
    want = np.asarray(jmt._ray_sort_keys(jnp.asarray(o), jnp.asarray(d),
                                         jtris))
    got = tmt._ray_sort_keys(torch.from_numpy(o), torch.from_numpy(d), ttris)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels

def test_closest_plain_matches_reference_kernel():
    """``_closest_plain`` against the interpreted Pallas kernel and the
    reference's jnp oracle, on the reference's packed data, with excludes;
    600 rays (a ragged second ray tile)."""
    jsoup, _ = _halls(8, 3, 2)
    jtris = jmt.build_pallas_triangles(jsoup, cull=False)
    o, d, ex = _rays(2, 600, jtris.num)
    got = tmt._closest_plain(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(ex), _carried(jtris))
    got = tuple(x.numpy() for x in got)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), jtris)
    ties_k = _assert_closest(got, jmt._pallas_closest(*jargs, interpret=True),
                             o, d, jtris.packed)
    ties_j = _assert_closest(got, jmt._jnp_closest(*jargs), o, d,
                             jtris.packed)
    assert (got[0] < tmt.BIG).mean() > 0.99
    assert ties_k <= 6 and ties_j <= 6, (ties_k, ties_j)


def test_closest_culled_plain_matches_reference_kernel(monkeypatch):
    """``_closest_culled_plain`` against the interpreted culled kernel on
    the same Morton-sorted data and the same sorted rays; the gate skips
    one (ray tile, triangle tile) pair."""
    jsoup, tsoup = _halls(10, 3, 3)               # 1362 triangles: two tiles
    jtris = jmt.build_pallas_triangles(jsoup, cull=True)
    ttris = _carried(jtris)
    o, d = _rays(3, 1024)
    order = np.argsort(np.asarray(jmt._ray_sort_keys(
        jnp.asarray(o), jnp.asarray(d), jtris)), kind="stable")
    # a third ray tile that cannot reach the second triangle tile (z ≥ 7.5):
    # low origins heading down
    lo_o, lo_d = _rays(13, tmt.RB)
    lo_o[:, 2] = np.minimum(lo_o[:, 2], 7.0)
    lo_d[:, 2] = -np.abs(lo_d[:, 2])
    o, d = np.concatenate([o[order], lo_o]), np.concatenate([d[order], lo_d])
    ex = np.full(len(o), -1, np.int32)
    scanned, mt_tile = [], tmt._mt_tile

    def recording(o_, d_, ex_, tile, base, *rest):
        scanned.append(base)
        return mt_tile(o_, d_, ex_, tile, base, *rest)

    monkeypatch.setattr(tmt, "_mt_tile", recording)
    got = tmt._closest_culled_plain(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(ex), ttris)
    monkeypatch.undo()
    want = jmt._pallas_closest(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(ex), jtris, interpret=True)
    ties = _assert_closest(tuple(x.numpy() for x in got), want, o, d,
                           jtris.packed)
    assert ties <= 6, ties
    assert float(ttris.tile_boxes[1, 2]) == 7.5
    # the triangle tiles each of the three ray tiles scanned, in order
    assert scanned == [0, tmt.TB, 0, tmt.TB, 0]
    # culled and all-pairs plain versions agree on the same sorted data
    t_all, i_all = tmt._closest_plain(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(ex),
        tmt.MtTriangles(ttris.packed, ttris.num))
    assert torch.equal(t_all, got[0]) and torch.equal(i_all, got[1])


def test_duplicated_triangle_lowest_id_wins():
    """Equal t: the lower id wins, also across the tile boundary."""
    _, tsoup = _halls(6, 0, 1)                    # 432 triangles
    dup = tg.TriangleSoup(
        tsoup.vertices,
        torch.cat([tsoup.triangles, tsoup.triangles, tsoup.triangles]),
        torch.cat([tsoup.surfaces] * 3))          # 1296: ids 1024.. repeat
    tris = tmt.build_mt_triangles(dup)
    o, d = _rays(4, 300)
    t, i, hit = tmt.mt_intersection(torch.from_numpy(o), torch.from_numpy(d),
                                    tris)
    assert bool(hit.all()) and int(i.max()) < 432
    t1, i1, _ = tmt.mt_intersection(torch.from_numpy(o),
                                    torch.from_numpy(d), tris,
                                    exclude_triangle=i)
    assert torch.equal(t1, t) and torch.equal(i1, i + 432)


# ---------------------------------------------------------------------------
# the queries

def test_mt_intersection_matches_reference():
    """R = 100 (a ragged ray tile), rays relaunched from a first hit with
    that triangle excluded; culled against unculled in the port; all-miss
    rays."""
    jsoup, tsoup = _halls(6, 0, 1)
    o, d = _rays(5, 100)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    results = {}
    for cull in (False, True):
        jtris = jmt.build_pallas_triangles(jsoup, cull=cull)
        ttris = tmt.build_mt_triangles(tsoup, cull=cull)
        t, tri, hit = tmt.mt_intersection(to, td, ttris)
        assert bool(hit.all()) and tri.dtype == torch.int32
        # relaunched from the hit point, back the way it came
        p2, d2 = (to + td * t[:, None]).numpy(), -d
        t2, tri2, hit2 = tmt.mt_intersection(
            torch.from_numpy(p2), torch.from_numpy(d2), ttris,
            exclude_triangle=tri)
        assert bool(hit2.all())
        assert not bool((tri2 == tri).any())
        jt2, jtri2, jhit2 = jmt.mt_intersection(
            jnp.asarray(p2), jnp.asarray(d2), jtris,
            exclude_triangle=jnp.asarray(tri.numpy()), interpret=True)
        assert np.array_equal(hit2.numpy(), np.asarray(jhit2))
        m = hit2.numpy()
        np.testing.assert_allclose(t2.numpy()[m], np.asarray(jt2)[m],
                                   rtol=T_RTOL)
        assert (tri2.numpy()[m] == np.asarray(jtri2)[m]).mean() >= 0.98
        assert np.all(np.isinf(t2.numpy()[~m]))
        results[cull] = (t2, tri2, hit2)
    (t0, i0, h0), (t1, i1, h1) = results[False], results[True]
    assert torch.equal(h0, h1) and torch.equal(t0, t1)
    assert torch.equal(i0[h0], i1[h0])
    # rays outside the scene, pointing away: every one misses
    out_o = torch.from_numpy(o) + 100.0
    away = torch.ones_like(out_o) / 3 ** 0.5
    for ttris in (tmt.build_mt_triangles(tsoup, cull=c)
                  for c in (False, True)):
        t, i, hit = tmt.mt_intersection(out_o, away, ttris)
        assert not bool(hit.any()) and bool(torch.isinf(t).all())
        want_id = 0 if not ttris.culled else int(ttris.perm[0])
        assert bool((i == want_id).all())


def test_culled_matches_unculled_with_excludes():
    """1024 rays on a hall of two triangle tiles, random excludes: t, hit and
    the ids at hits equal (the reference's test_culled_matches_plain_jnp)."""
    _, tsoup = _halls(10, 3, 3)
    o, d, ex = _rays(0, 1024, tsoup.num_triangles)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    t0, i0, h0 = tmt.mt_intersection(
        *args, tmt.build_mt_triangles(tsoup, cull=False), torch.from_numpy(ex))
    t1, i1, h1 = tmt.mt_intersection(
        *args, tmt.build_mt_triangles(tsoup, cull=True), torch.from_numpy(ex))
    np.testing.assert_allclose(t0.numpy(), t1.numpy(), rtol=1e-6)
    assert torch.equal(h0, h1) and torch.equal(i0[h0], i1[h0])
    td, idd, hd = tg.scene_intersection(*args, tsoup, torch.from_numpy(ex))
    assert torch.equal(hd, h0)
    np.testing.assert_allclose(t0.numpy(), td.numpy(), rtol=T_RTOL)
    assert (i0 == idd).float().mean() >= 0.98


def test_mt_line_of_sight_matches():
    jsoup, tsoup = _halls(6, 4, 2)
    rng = np.random.default_rng(3)
    a, b = (rng.uniform([1, 1, 1], [19, 7, 14], (256, 3)).astype(np.float32)
            for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    dense = tg.line_of_sight(ta, tb, tsoup).numpy()
    assert 0.1 < dense.mean() < 0.99             # the columns block some
    for cull in (False, True):
        got = tmt.mt_line_of_sight(
            ta, tb, tmt.build_mt_triangles(tsoup, cull=cull)).numpy()
        assert (got == dense).mean() > 0.99
    want = np.asarray(jmt.mt_line_of_sight(
        jnp.asarray(a), jnp.asarray(b), jmt.build_pallas_triangles(jsoup)))
    assert (tmt.mt_line_of_sight(ta, tb, tmt.build_mt_triangles(tsoup))
            .numpy() == want).mean() > 0.99


def test_grid_queries_match():
    """The DDA against the reference's DDA on the same rays and against the
    port's dense broadcast: t rtol 1e-5, hits equal, ≥ 98 % of ids."""
    jsoup, tsoup = _halls(8, 3, 2)
    jgrid, tgrid = jaccel.build_ray_grid(jsoup), taccel.build_ray_grid(tsoup)
    o, d, ex = _rays(6, 512, tsoup.num_triangles)
    to, td, tex = (torch.from_numpy(x) for x in (o, d, ex))
    for exclude in (None, ex):
        t_ex = None if exclude is None else tex
        tg_, ig_, hg_ = taccel.grid_intersection(to, td, tgrid, tsoup, t_ex)
        jt_, ji_, jh_ = jaccel.grid_intersection(
            jnp.asarray(o), jnp.asarray(d), jgrid, jsoup,
            None if exclude is None else jnp.asarray(exclude))
        tdn, idn, hdn = tg.scene_intersection(to, td, tsoup, t_ex)
        for wt, wi, wh in ((np.asarray(jt_), np.asarray(ji_),
                            np.asarray(jh_)),
                           (tdn.numpy(), idn.numpy(), hdn.numpy())):
            assert np.array_equal(hg_.numpy(), wh)
            np.testing.assert_allclose(tg_.numpy()[wh], wt[wh], rtol=T_RTOL)
            assert (ig_.numpy()[wh] == wi[wh]).mean() >= 0.98
    # relaunched from the hit surface with it excluded: no self-hit
    _, tri, hit = taccel.grid_intersection(to, td, tgrid, tsoup)
    _, tri2, hit2 = taccel.grid_intersection(to, td, tgrid, tsoup, tri)
    m = hit & hit2
    assert not bool((tri2[m] == tri[m]).any())
    # line of sight
    rng = np.random.default_rng(3)
    a, b = (rng.uniform([1, 1, 1], [19, 7, 14], (256, 3)).astype(np.float32)
            for _ in range(2))
    got = taccel.grid_line_of_sight(torch.from_numpy(a), torch.from_numpy(b),
                                    tgrid, tsoup).numpy()
    want = np.asarray(jaccel.grid_line_of_sight(
        jnp.asarray(a), jnp.asarray(b), jgrid, jsoup))
    dense = tg.line_of_sight(torch.from_numpy(a), torch.from_numpy(b),
                             tsoup).numpy()
    assert (got == want).mean() > 0.99 and (got == dense).mean() > 0.99


# ---------------------------------------------------------------------------
# the tracer

def _box_soups():
    jsoup = jg.box_scene(jg.Box(*BOX))
    return jsoup, convert.soup_from_numpy(
        np.asarray(jsoup.vertices), np.asarray(jsoup.triangles),
        np.asarray(jsoup.surfaces))


def _tsurf():
    return convert.surface_from_numpy(np.full((1, 8), 0.1),
                                      np.full((1, 8), 0.1))


@pytest.mark.parametrize("backend", ["grid", "mt", "mt_culled"])
def test_trace_with_accel_matches_dense_on_box(backend):
    """The same draws ⇒ the same bounce sequence ⇒ the same histogram."""
    _, tsoup = _box_soups()
    accel = {"grid": lambda: taccel.build_ray_grid(tsoup),
             "mt": lambda: tmt.build_mt_triangles(tsoup),
             "mt_culled": lambda: tmt.build_mt_triangles(tsoup, cull=True)
             }[backend]()
    kwargs = dict(num_rays=512, depth=12, max_time=0.6)
    dense, fast = (tt.trace(tsoup, _tsurf(), (2.1, 2.1, 1.2), (2.1, 3.0, 0.9),
                            torch.Generator().manual_seed(5), accel=a,
                            **kwargs) for a in (None, accel))
    assert torch.equal(fast.triangle_history, dense.triangle_history)
    np.testing.assert_allclose(fast.histogram.numpy(),
                               dense.histogram.numpy(), rtol=1e-4, atol=1e-8)
    assert float(dense.histogram.sum()) > 0


@pytest.mark.parametrize("backend", ["grid", "mt", "mt_culled"])
def test_trace_with_accel_matches_reference(backend):
    """``trace`` on a small hall against the reference's ``trace`` with the
    same backend and the reference's draws: hit history equal on ≥ 99.5 % of
    entries, per-band histogram totals within 1e-3."""
    jsoup, tsoup = _halls(8, 2, 2)
    if backend == "grid":
        jacc, tacc = jaccel.build_ray_grid(jsoup), \
            taccel.build_ray_grid(tsoup)
    else:
        cull = backend == "mt_culled"
        jacc = jmt.build_pallas_triangles(jsoup, cull=cull)
        tacc = tmt.build_mt_triangles(tsoup, cull=cull)
    rays, depth = 256, 6
    src, rcv = (2.0, 1.7, 3.0), (6.0, 1.9, 9.0)
    key = jax.random.PRNGKey(3)
    jsurf = JSurface(absorption=jnp.full((1, 8), 0.1),
                     scattering=jnp.full((1, 8), 0.1))
    want = jt.trace(jsoup, jsurf, src, rcv, key, num_rays=rays, depth=depth,
                    max_time=0.4, accel=jacc)
    got = tt.trace(tsoup, _tsurf(), src, rcv, None, num_rays=rays,
                   depth=depth, max_time=0.4, accel=tacc,
                   directions=reference_directions(key, rays, depth))
    agree = np.mean(got.triangle_history.numpy()
                    == np.asarray(want.triangle_history))
    assert agree >= 0.995, agree
    g, w = got.histogram.numpy(), np.asarray(want.histogram)
    assert g.shape == w.shape and w.sum() > 0
    np.testing.assert_allclose(g.sum(axis=(0, 1, 2)), w.sum(axis=(0, 1, 2)),
                               rtol=1e-3)


def test_auto_accel_and_dispatch():
    assert taccel.auto_accel(tscenes.procedural_hall(2, 4, 1)[0],
                             "cpu") is None
    soup = tscenes.procedural_hall(3, 2, 1)[0]
    assert soup.num_triangles == 132
    grid = taccel.auto_accel(soup, torch.device("cpu"))
    assert isinstance(grid, taccel.RayGrid)
    assert grid.cells.device.type == "cpu"
    with pytest.raises(TypeError):          # the device is the caller's to say
        taccel.auto_accel(soup)
    # trace takes either structure and refuses anything else
    for accel in (grid, tmt.build_mt_triangles(soup)):
        res = tt.trace(soup, _tsurf(), (6.0, 4.0, 5.0), (7.5, 3.0, 6.5),
                       torch.Generator().manual_seed(0), num_rays=64, depth=2,
                       max_time=0.2, accel=accel)
        assert res.triangle_history.shape == (2, 64)
        assert int(res.triangle_history.min()) >= 0
    with pytest.raises(TypeError, match="accel"):
        tt.trace(soup, _tsurf(), (6.0, 4.0, 5.0), (7.5, 3.0, 6.5),
                 torch.Generator().manual_seed(0), num_rays=8, depth=1,
                 max_time=0.2, accel=object())
    moved = grid.to("cpu")
    assert moved.res == grid.res and torch.equal(moved.cells, grid.cells)


def test_mt_closest_refuses_gradients():
    soup = tscenes.procedural_hall(3, 2, 1)[0]
    tris = tmt.build_mt_triangles(soup)
    o, d = _rays(1, 16)
    ex = torch.full((16,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no gradient"):
        tmt.mt_closest(torch.from_numpy(o).requires_grad_(True),
                       torch.from_numpy(d), ex, tris)
    before = (tmt.mt_closest.launches, tmt.mt_closest.culled_launches)
    tmt.mt_closest(torch.from_numpy(o), torch.from_numpy(d), ex, tris)
    # the plain version served the CPU tensors: no launch is counted
    assert (tmt.mt_closest.launches,
            tmt.mt_closest.culled_launches) == before


# ---------------------------------------------------------------------------
# image sources on a scene above 100 triangles

def test_validate_paths_blocked_equals_unblocked(monkeypatch):
    """The dense test walks its rows in blocks; the numbers do not change."""
    jsoup, tsoup = _halls(3, 2, 1)
    rng = np.random.default_rng(8)
    paths = rng.integers(0, tsoup.num_triangles, (300, 3)).astype(np.int32)
    src, rcv = (6.0, 4.0, 5.0), (7.5, 3.0, 6.5)
    whole = ttree.validate_paths(paths, tsoup, src, rcv)
    monkeypatch.setattr(tg, "DENSE_MAX_PAIRS", 37 * tsoup.num_triangles)
    blocked = ttree.validate_paths(paths, tsoup, src, rcv)
    for f in ("image_position", "cos_angles", "surfaces", "valid"):
        assert np.array_equal(getattr(whole, f), getattr(blocked, f),
                              equal_nan=True), f
    o, d, ex = _rays(9, 200, tsoup.num_triangles)
    args = (torch.from_numpy(o), torch.from_numpy(d), tsoup,
            torch.from_numpy(ex))
    few = tg.scene_intersection(*args)
    monkeypatch.undo()
    for a, b in zip(few, tg.scene_intersection(*args)):
        assert torch.equal(a, b)
    want = jtree.validate_paths(paths, jsoup, src, rcv)
    assert np.array_equal(whole.valid, np.asarray(want.valid))
