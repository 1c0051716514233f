"""The cluster split of the culled closest-hit kernel B4, on the CPU.

B4 walks each 512-ray gate tile's triangle tiles with a thread-block cluster
of C CTAs: for each triangle tile the gate lets through, CTA c scans the
contiguous share [c·1024/C, (c+1)·1024/C) of it from the rays' merged best,
and the C partial (t, id) are merged by their lexicographic minimum before
the next tile's vote.  Built here from the plain version's own pieces
(``_ray_blocks``, ``_slab_possible``, ``_mt_tile`` on sub-ranges), that scan
must equal ``_closest_culled_plain`` to the bit at every C, in either order
of the shares, ties between shares included.  No JAX: the argument is about
the port's kernel and its plain version; the CUDA kernel is held against the
plain version on a GPU in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from wayverb_tpu_torch.raytracer import mt_kernels as mk
from wayverb_tpu_torch.raytracer.scenes import procedural_hall
from wayverb_tpu_torch.tools.rays_timing import edge_rays


def _cluster_scan(origin, direction, exclude, tris, C, reverse=False):
    """The culled scan as a cluster of C CTAs computes it."""
    R = origin.shape[0]
    share = mk.TB // C
    t_out = torch.empty(R, dtype=torch.float32)
    i_out = torch.empty(R, dtype=torch.int32)
    for r0, rows, o, d, ex in mk._ray_blocks(origin, direction, exclude):
        tiny = torch.where(d >= 0, 1e-20, -1e-20).to(d.dtype)
        rd = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
        best_t = torch.full((mk.RB,), mk.BIG, dtype=torch.float32)
        best_i = torch.zeros(mk.RB, dtype=torch.int32)
        for ti, base in enumerate(range(0, tris.packed.shape[1], mk.TB)):
            if not bool(mk._slab_possible(o, rd, tris.tile_boxes[ti],
                                          best_t).any()):
                continue
            parts = [mk._mt_tile(
                o, d, ex, tris.packed[:, base + c * share:
                                      base + (c + 1) * share],
                base + c * share, tris.num, best_t, best_i)
                for c in range(C)]
            for t, i in reversed(parts) if reverse else parts:
                take = (t < best_t) | ((t == best_t) & (i < best_i))
                best_t = torch.where(take, t, best_t)
                best_i = torch.where(take, i, best_i)
        t_out[r0:r0 + rows] = best_t[:rows]
        i_out[r0:r0 + rows] = best_i[:rows]
    return t_out, i_out


def _culled_table(corners):
    """Culled tables over (T, 3, 3) corners kept in their order (no Morton
    sort), with tile boxes as ``build_mt_triangles`` computes them."""
    c = np.asarray(corners, dtype=np.float32)
    T = c.shape[0]
    Tpad = -(-T // mk.TB) * mk.TB
    packed = np.concatenate([c[:, 0].T, (c[:, 1] - c[:, 0]).T,
                             (c[:, 2] - c[:, 0]).T], axis=0)
    packed = np.pad(packed, ((0, 0), (0, Tpad - T)))
    boxes = np.zeros((Tpad // mk.TB, 8), np.float32)
    for ti in range(boxes.shape[0]):
        blk = c[ti * mk.TB:(ti + 1) * mk.TB].reshape(-1, 3)
        boxes[ti, :3], boxes[ti, 3:6] = blk.min(axis=0), blk.max(axis=0)
    return mk.MtTriangles(packed=torch.from_numpy(
        np.ascontiguousarray(packed)), num=T,
        tile_boxes=torch.from_numpy(boxes))


TIE_COPIES = (1000, 128, 127, 700, 1024 + 3)   # copies of one triangle


def _tie_scene():
    """Copies of one triangle at TIE_COPIES: 127 and 128 straddle the
    shares of C = 8, 127 and 700 or 1000 those of C = 2 and 4, 1027 lies in
    the next tile; every other slot holds a small triangle far from the
    rays.  Rays from above the triangle, half excluding id 127: the lowest
    id wins among equal t (127, then 128)."""
    rng = np.random.default_rng(5)
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    far = 100.0 + rng.uniform(0.0, 10.0, (1500, 1, 3)) \
        + rng.uniform(0.0, 0.1, (1500, 3, 3))
    corners = far.copy()
    corners[list(TIE_COPIES)] = tri
    n = 700
    o = np.stack([rng.uniform(0.05, 0.45, n), rng.uniform(0.05, 0.45, n),
                  rng.uniform(0.5, 2.0, n)], axis=1)
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    ex = np.where(np.arange(n) % 2 == 0, -1, 127)
    return corners, o, d, ex


def _slack_scene(rows, voter_row, rays):
    """One triangle whose box a ray just outside its edge misses: ray A at
    row ``rows[0]`` hits it only through the barycentric slack, and only
    if ray B (row ``voter_row``) shares A's gate tile and votes for the
    tile; every other ray points away and never votes (nor do the zero rays
    of a ragged tile: the box lies in the negative octant)."""
    tri = np.array([[[-3.0, -3.0, -2.0], [-2.0, -3.0, -2.0],
                     [-3.0, -2.0, -2.0]]])
    o = np.tile([-2.5, -2.5, -1.0], (rays, 1))
    d = np.tile([0.0, 0.0, 1.0], (rays, 1))
    o[rows[0]] = (-2.5, -3.00005, -1.0)
    d[rows[0]] = (0.0, 0.0, -1.0)
    o[voter_row] = (-2.7, -2.7, -1.0)
    d[voter_row] = (0.0, 0.0, -1.0)
    return tri, o, d, np.full(rays, -1)


def _hall_scene():
    """The procedural hall (5,448 triangles, six tiles), Morton-sorted,
    700 random rays inside it with random excludes, sorted for the gate."""
    soup, _ = procedural_hall()
    tris = mk.build_mt_triangles(soup, cull=True)
    rng = np.random.default_rng(11)
    n = 700
    o = (0.05 + 0.9 * rng.random((n, 3))) * np.array([20.0, 8.0, 15.0])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ex = rng.integers(-1, 5448, n)
    return tris, o, d, ex


def _scene(name):
    if name == "hall":
        tris, o, d, ex = _hall_scene()
    else:
        if name == "ties":
            corners, o, d, ex = _tie_scene()
        elif name == "slack, one voter in the tile":
            corners, o, d, ex = _slack_scene((0,), 511, 512)
        elif name == "slack, the voter in the next tile":
            corners, o, d, ex = _slack_scene((0,), 512, 1024)
        else:   # "slack, a ragged tile of 300 rays"
            corners, o, d, ex = _slack_scene((0,), 299, 300)
        tris = _culled_table(corners)
    o, d = (torch.tensor(x, dtype=torch.float32) for x in (o, d))
    ex = torch.tensor(ex, dtype=torch.int32)
    if name == "hall":
        order = torch.argsort(mk._ray_sort_keys(o, d, tris), stable=True)
        o, d, ex = o[order], d[order], ex[order]
    return tris, o.contiguous(), d.contiguous(), ex.contiguous()


SCENES = ("hall", "ties", "slack, one voter in the tile",
          "slack, the voter in the next tile",
          "slack, a ragged tile of 300 rays")


@pytest.mark.parametrize("C", (1, 2, 4, 8))
@pytest.mark.parametrize("scene", SCENES)
def test_cluster_merge_equals_the_sequential_gate(scene, C):
    """The merged partial scans of C shares equal the plain culled version
    to the bit, whichever order the shares are merged in."""
    tris, o, d, ex = _scene(scene)
    want = mk._closest_culled_plain(o, d, ex, tris)
    for reverse in (False, True):
        got = _cluster_scan(o, d, ex, tris, C, reverse=reverse)
        assert torch.equal(got[0], want[0]), (scene, C, reverse)
        assert torch.equal(got[1], want[1]), (scene, C, reverse)


def test_the_scenes_test_what_they_claim():
    """The tie scene resolves to the lowest id among equal t; the slack
    scene's ray A hits only when its gate tile holds the voter."""
    tris, o, d, ex = _scene("ties")
    t, i = mk._closest_culled_plain(o, d, ex, tris)
    assert bool((t < mk.BIG).all())
    assert torch.equal(i, torch.where(ex == 127, 128, 127).to(torch.int32))
    for name, a_hits in (("slack, one voter in the tile", True),
                         ("slack, the voter in the next tile", False),
                         ("slack, a ragged tile of 300 rays", True)):
        tris, o, d, ex = _scene(name)
        t, i = mk._closest_culled_plain(o, d, ex, tris)
        voter = int(torch.nonzero((o[:, 0] == -2.7)).item())
        assert float(t[voter]) == 1.0 and int(i[voter]) == 0, name
        assert (float(t[0]) == 1.0) == a_hits, (name, float(t[0]))
        # ray A alone would not pass the box test of its tile
        rd = 1.0 / torch.where(d[:1].abs() < 1e-20,
                               torch.full_like(d[:1], 1e-20), d[:1])
        assert not bool(mk._slab_possible(
            o[:1], rd, tris.tile_boxes[0], torch.full((1,), mk.BIG)).any())
        others = torch.ones(o.shape[0], dtype=torch.bool)
        others[[0, voter]] = False
        assert bool((t[others] == mk.BIG).all()), name



@pytest.mark.parametrize("rays", ["hall", "edges", "all-pairs hall",
                                  "all-pairs edges"])
def test_the_skip_tests_never_drop_a_hit(rays):
    """Every (ray, triangle) hit, with its running best at BIG or at a
    nearer hit, passes both tests that the scan of B3 and B4 takes before
    the reciprocal (``_skip_tests_plain``: u, then u, v and u + v, widened
    by more than the roundings of the reciprocal and of the products): so
    skipping a triangle for a warp whose lanes all fail them leaves every
    result's bits as they are.  On the culled table with the rays sorted,
    and on the all-pairs table (B3's) with the rays in their own order."""
    tris, o, d, ex = _scene("hall")
    if rays.startswith("all-pairs"):
        rng = np.random.default_rng(11)
        tris = mk.build_mt_triangles(procedural_hall()[0], cull=False)
        ex = torch.tensor(rng.integers(-1, tris.num, o.shape[0]),
                          dtype=torch.int32)
    rng = np.random.default_rng(3)
    hits = 0
    for ti, base in enumerate(range(0, tris.packed.shape[1], mk.TB)):
        tile = tris.packed[:, base:base + mk.TB]
        if rays.endswith("edges"):
            o, d = edge_rays(tile[:, :min(mk.TB, tris.num - base)], 2048,
                             rng)
            ex = torch.full((o.shape[0],), -1, dtype=torch.int32)
        pass_u, pass_uv = mk._skip_tests_plain(o, d, tile)
        hit_any, t = mk._mt_hits(o, d, ex, tile, base, tris.num)
        for best in (mk.BIG, 10.0, 1.0):
            hit = hit_any & (t < best)
            assert not bool((hit & ~pass_u).any()), (ti, best)
            assert not bool((hit & ~pass_uv).any()), (ti, best)
            hits += int(hit.sum())
    assert hits > 1000
