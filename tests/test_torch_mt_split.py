"""The split of the all-pairs closest-hit kernel B3, on the CPU.

B3 gives each block of rays a thread-block cluster of C CTAs and splits the
triangle axis: CTA c scans the contiguous share ``mt_kernels.b3_shares(num,
C)[c]`` of the real triangles from "no hit yet" (t = 3.4e38, id 0), staging
it ``STAGE`` triangles at a time, and after the last triangle the C
partial (t, id) are merged once by their lexicographic minimum.  Built here
from the plain version's own ``_mt_tile`` on those sub-ranges, that scan
must equal ``_closest_plain`` to the bit at every C, in either order of the
shares: ties between shares, an exclude that lies in another CTA's share,
fewer real triangles than shares, rays on the slack's edges.  No JAX: the
argument is about the port's kernel and its plain version; the CUDA kernel
is held against the plain version on these scenes on a GPU in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from wayverb_tpu_torch.core.geometry import Box, box_scene
from wayverb_tpu_torch.raytracer import mt_kernels as mk
from wayverb_tpu_torch.raytracer.scenes import procedural_hall

from wayverb_tpu_torch.tools.rays_timing import edge_rays

from test_torch_mt_cluster import TIE_COPIES, _tie_scene

# triangles a CTA of B3 stages at a time (kStage, csrc/ray_mt_closest.cu)
STAGE = 1024


def _split_scan(origin, direction, exclude, tris, C, reverse=False):
    """The all-pairs scan as a cluster of C CTAs computes it."""
    R = origin.shape[0]
    parts = []
    for lo, hi in mk.b3_shares(tris.num, C):
        t = torch.full((R,), mk.BIG, dtype=torch.float32)
        i = torch.zeros(R, dtype=torch.int32)
        for first in range(lo, hi, STAGE):
            last = min(first + STAGE, hi)
            t, i = mk._mt_tile(origin, direction, exclude,
                               tris.packed[:, first:last], first, tris.num,
                               t, i)
        parts.append((t, i))
    best_t = torch.full((R,), mk.BIG, dtype=torch.float32)
    best_i = torch.zeros(R, dtype=torch.int32)
    for t, i in reversed(parts) if reverse else parts:
        take = (t < best_t) | ((t == best_t) & (i < best_i))
        best_t = torch.where(take, t, best_t)
        best_i = torch.where(take, i, best_i)
    return best_t, best_i


def _table(corners):
    """An all-pairs table over (T, 3, 3) corners kept in their order."""
    c = np.asarray(corners, dtype=np.float32)
    T = c.shape[0]
    Tpad = -(-T // mk.TB) * mk.TB
    packed = np.concatenate([c[:, 0].T, (c[:, 1] - c[:, 0]).T,
                             (c[:, 2] - c[:, 0]).T], axis=0)
    packed = np.pad(packed, ((0, 0), (0, Tpad - T)))
    return mk.MtTriangles(packed=torch.from_numpy(
        np.ascontiguousarray(packed)), num=T)


def _hall_rays(n, rng, num):
    o = (0.05 + 0.9 * rng.random((n, 3))) * np.array([20.0, 8.0, 15.0])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.integers(-1, num, n)


B3_SCENES = ("hall", "hall, 100 rays", "hall, 1500 rays",
             "hall, a quarter of the origins not finite", "ties",
             "an exclude in another share", "3 triangles", "12 triangles",
             "slack edges")


def _b3_scene(name):
    """(all-pairs table, origin, direction, exclude) on the CPU."""
    rng = np.random.default_rng(17)
    if name.startswith("hall") or name == "slack edges":
        tris = mk.build_mt_triangles(procedural_hall()[0], cull=False)
        if name == "slack edges":
            o, d = edge_rays(tris.packed[:, :tris.num], 1024, rng)
            ex = np.full(o.shape[0], -1)
        else:
            n = {"hall, 100 rays": 100, "hall, 1500 rays": 1500,
                 "hall": 700}.get(name, 1024)
            o, d, ex = _hall_rays(n, rng, tris.num)
            if "finite" in name:
                o[0::8] = np.nan
                o[1::8, 0] = np.inf
    elif name in ("3 triangles", "12 triangles"):
        soup = box_scene(Box((0.0, 0.0, 0.0), (20.0, 8.0, 15.0)))
        n = int(name.split()[0])
        tris = _table(soup.corners()[:n].numpy())
        o, d, ex = _hall_rays(500, rng, n)
    else:
        corners, o, d, ex = _tie_scene()
        if name == "an exclude in another share":
            # the two copies lie in the first and the last share at every
            # C > 1: a ray that excludes the first hits the last
            tri = corners[TIE_COPIES[0]].copy()
            far = np.delete(np.arange(corners.shape[0]), TIE_COPIES)
            corners[list(TIE_COPIES)] = corners[far[:len(TIE_COPIES)]]
            corners[[100, 1400]] = tri
            ex = np.where(np.arange(o.shape[0]) % 2 == 0, -1, 100)
        tris = _table(corners)
    o, d = (torch.as_tensor(x, dtype=torch.float32) for x in (o, d))
    ex = torch.as_tensor(ex, dtype=torch.int32)
    return tris, o.contiguous(), d.contiguous(), ex.contiguous()


def test_the_shares_cover_the_triangles_once():
    for num in (1, 3, 12, 1500, 5448, 97068):
        for C in (1, 2, 4, 8):
            shares = mk.b3_shares(num, C)
            assert shares[0][0] == 0 and shares[-1][1] == num
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            sizes = [hi - lo for lo, hi in shares]
            assert max(sizes) - min(sizes) <= 1, (num, C)


@pytest.mark.parametrize("C", (1, 2, 4, 8))
@pytest.mark.parametrize("scene", B3_SCENES)
def test_split_merge_equals_the_all_pairs_scan(scene, C):
    """The merged partial scans of C shares equal the plain all-pairs
    version to the bit, whichever order the shares are merged in."""
    tris, o, d, ex = _b3_scene(scene)
    want = mk._closest_plain(o, d, ex, tris)
    for reverse in (False, True):
        got = _split_scan(o, d, ex, tris, C, reverse=reverse)
        assert torch.equal(got[0], want[0]), (scene, C, reverse)
        assert torch.equal(got[1], want[1]), (scene, C, reverse)


def test_the_scenes_test_what_they_claim():
    """Equal t in several shares resolves to the lowest id; a ray that
    excludes the first copy hits the copy in the last share; three
    triangles leave some of eight shares empty and still hit; the slack
    edges and the dead rays are there."""
    tris, o, d, ex = _b3_scene("ties")
    t, i = mk._closest_plain(o, d, ex, tris)
    assert bool((t < mk.BIG).all())
    assert torch.equal(i, torch.where(ex == 127, 128, 127).to(torch.int32))
    shares = mk.b3_shares(tris.num, 8)
    assert sum(lo <= 700 < hi for lo, hi in shares[1:]) == 1
    tris, o, d, ex = _b3_scene("an exclude in another share")
    t, i = mk._closest_plain(o, d, ex, tris)
    assert bool((t < mk.BIG).all())
    assert torch.equal(i, torch.where(ex == 100, 1400, 100).to(torch.int32))
    for C in (2, 4, 8):
        first, last = mk.b3_shares(tris.num, C)[0], mk.b3_shares(
            tris.num, C)[-1]
        assert first[0] <= 100 < first[1] and last[0] <= 1400 < last[1]
    tris, o, d, ex = _b3_scene("3 triangles")
    assert tris.num == 3 and mk.b3_shares(3, 8)[0] == (0, 0)
    t, _ = mk._closest_plain(o, d, ex, tris)
    assert 0.0 < float((t < mk.BIG).float().mean()) < 1.0
    tris, o, d, ex = _b3_scene("hall, a quarter of the origins not finite")
    t, _ = mk._closest_plain(o, d, ex, tris)
    assert bool((t[0::8] == mk.BIG).all()) and bool((t[1::8] == mk.BIG).all())
    assert float((t < mk.BIG).float().mean()) > 0.5
