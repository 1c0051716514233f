"""The port's fused box step against the JAX reference.

``plane_boundary_step_stacked`` and ``_fused_step_plain`` (the plain version
of the CUDA kernel) take the same numpy inputs as the JAX functions on the
CPU; the fused step is held against the Pallas kernel run in interpret mode
and against its pure-jnp reference ``_jnp_forward``, atol 1e-5 (the bound
``tests/test_box_fused.py`` holds the interpreted Pallas kernel to).  The
CUDA kernel itself is held against the plain version on a GPU, in
``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.waveguide import box_fused as jbf
from wayverb_tpu.waveguide.boundary import compute_boundary_coefficients
from wayverb_tpu_torch.waveguide import box_fused as tbf

torch.set_num_threads(2)

ATOL = 1e-5
# a 16-row x-shard (global rows 4..19) of a (20, 16, 128) grid: both x walls
# and both inner x planes fall inside the shard, and the Pallas kernel's
# (8, 8, 128) tiling holds
GLOBAL = dict(dims=(20, 16, 128), ilo=(6, 2, 2), ihi=(17, 13, 125),
              face_surface=(0,) * 6)
X_OFF = 4
# (source (global x, y, z), mode): none; hard deep inside; soft on the low
# inner x plane; hard at the inner corner (ihi on every axis)
INJECTIONS = [((12, 9, 64), 0), ((12, 9, 64), 1), ((6, 7, 30), 2),
              ((17, 13, 125), 1)]


def _step_inputs(rng, dims):
    X, Y, Z = dims
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    planes = [f32(*s) for s in tbf._plane_shapes(X, Y, Z)]
    halos = [f32(1, Y, Z), f32(1, Y, Z)]
    return f32(X, Y, Z), f32(X, Y, Z), planes, halos, f32(2)


def _assert_step_close(got, want):
    (g_next, g_inner), (w_next, w_inner) = got, want
    np.testing.assert_allclose(g_next.numpy(), np.asarray(w_next), rtol=0,
                               atol=ATOL)
    for g, w in zip(g_inner, w_inner):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("src,mode", INJECTIONS)
def test_fused_step_plain_matches_reference(rng, src, mode):
    """Plain version vs the interpreted Pallas kernel and ``_jnp_forward``:
    halos, a non-zero x offset and every injection mode."""
    jspec = jbf.BoxSpec(**GLOBAL)
    tspec = tbf.BoxSpec(**GLOBAL)
    X = GLOBAL["dims"][0] - X_OFF
    cur, prev, planes, halos, inj_val = _step_inputs(
        rng, (X,) + GLOBAL["dims"][1:])
    inj_idx = src + (mode,)

    got = tbf._fused_step_plain(
        tspec.geom_array(x_offset=X_OFF), torch.from_numpy(cur),
        torch.from_numpy(prev), tuple(map(torch.from_numpy, planes)),
        inj_idx, torch.from_numpy(inj_val),
        tuple(map(torch.from_numpy, halos)))

    jgeom = jspec.geom_array(x_offset=X_OFF)
    jargs = (jnp.asarray(cur), jnp.asarray(prev),
             tuple(map(jnp.asarray, planes)))
    jinj = (jnp.asarray(inj_idx, dtype=jnp.int32), jnp.asarray(inj_val))
    jhalos = tuple(map(jnp.asarray, halos))
    _assert_step_close(got, jbf._jnp_forward(jgeom, *jargs, *jinj,
                                             halos=jhalos))
    _assert_step_close(got, jbf.fused_step(jspec, jgeom, *jargs, *jinj,
                                           halos=jhalos, interpret=True))


def test_fused_step_writes_into_out(rng):
    spec = tbf.BoxSpec(**GLOBAL)
    cur, prev, planes, _, _ = _step_inputs(rng, GLOBAL["dims"])
    args = (spec.geom_array(), torch.from_numpy(cur), torch.from_numpy(prev),
            tuple(map(torch.from_numpy, planes)))
    out = torch.full(GLOBAL["dims"], float("nan"))
    nxt, inner = tbf.fused_step(*args, out=out)
    assert nxt is out
    want, want_inner = tbf._fused_step_plain(*args)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(inner, want_inner))


@pytest.mark.parametrize("absorption", [0.1, 0.6])
def test_plane_boundary_step_stacked_matches(rng, absorption):
    inside = np.zeros((12, 14, 17), dtype=bool)
    inside[2:-2, 2:-3, 3:-2] = True
    jspec = jbf.spec_from_inside(inside)
    tspec = tbf.spec_from_inside(inside)
    Umax, Vmax = tbf.stacked_plane_shape(tspec)
    act, _ = tbf._stacked_masks(tspec, Umax, Vmax)
    c = compute_boundary_coefficients(np.full(8, absorption), 3333.33)
    fb = np.tile(np.asarray(c.b, np.float32), (6, 1))
    fa = np.tile(np.asarray(c.a, np.float32), (6, 1))
    planes = [(rng.normal(size=(6, Umax, Vmax)) * act).astype(np.float32)
              for _ in range(3)]
    st = (rng.normal(size=(6, Umax, Vmax, 6))
          * act[..., None]).astype(np.float32)
    want = jbf.plane_boundary_step_stacked(
        *map(jnp.asarray, planes + [st]), jspec, jnp.asarray(fb),
        jnp.asarray(fa))
    got = tbf.plane_boundary_step_stacked(
        *map(torch.from_numpy, planes + [st]), tspec, torch.from_numpy(fb),
        torch.from_numpy(fa))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_stack_unstack_roundtrip(rng):
    spec = tbf.BoxSpec(**GLOBAL)
    planes = tuple(torch.from_numpy(rng.normal(size=spec.plane_shape(p))
                                    .astype(np.float32)) for p in range(6))
    stack = tbf.stack_planes(planes, spec)
    assert stack.shape == (6,) + tbf.stacked_plane_shape(spec)
    for a, b in zip(tbf.unstack_planes(stack, spec), planes):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CUDA kernel's order of work, in plain torch

TILE_Z = 32   # the kernel's warp: 32 nodes along z


def _staged_row(cur, r, src, mode, v_now):
    """Row r of cur as the kernel reads it: a zero y/z border around it (the
    neighbours off the grid), the source's injected value in place, zeros
    for a row off the grid."""
    X, Y, Z = cur.shape
    if not 0 <= r < X:
        return torch.zeros(Y + 2, Z + 2)
    row = torch.nn.functional.pad(cur[r], (1, 1, 1, 1))
    if src is not None and src[0] == r:
        e = row[src[1] + 1, src[2] + 1]
        row[src[1] + 1, src[2] + 1] = v_now if mode == 1 else e + v_now
    return row


def _warp_paths(geom, shape, x, src, xin):
    """(bare, z only): (Y, Z) masks of the nodes of row x whose 32-node z
    warp the kernel runs bare (strictly between the inner planes in x, y and
    z, the clamped inner x rows included, away from the source) or with
    only the z tests (the same, but for z)."""
    _, Y, Z = shape
    y = torch.arange(Y).view(Y, 1)
    z0 = (torch.arange(Z) // TILE_Z * TILE_Z).view(1, Z)
    gx = geom[0] + x
    xy = ((y > geom[5]) & (y < geom[6])
          & bool(geom[3] <= gx <= geom[4] and x not in xin))
    if src is not None and abs(x - src[0]) <= 1:
        xy = xy & ~(((y - src[1]).abs() <= 1) & (src[2] >= z0 - 1)
                    & (src[2] <= z0 + TILE_Z))
    z_in = (z0 > geom[7]) & (z0 + TILE_Z - 1 < geom[8])
    return xy & z_in, xy & ~z_in


def _row_walk_step(geom, cur, prev, planes, inj_idx, inj_val, halos):
    """The fused step computed as the CUDA kernel computes it, row by row:
    a rolling window of three rows (x - 1, x, x + 1) with the injection in
    the rows read; the neighbour sum x-, x+, y-, y+, z-, z+ from zero, the
    halo row added last; bare warps get only the leapfrog, z-only warps the
    z inside test, the z splices and the z extractions, the others the full
    inside test, the source's prev, every splice and every extraction.
    Returns (next, inner)."""
    X, Y, Z = cur.shape
    sx, sy, sz, mode = inj_idx
    src = None
    if mode > 0 and 0 <= sx - geom[0] < X and 0 <= sy < Y and 0 <= sz < Z:
        src = (sx - geom[0], sy, sz)
    v_now, v_prev = (inj_val[0], inj_val[1]) if src else (None, None)
    xin = tuple(tbf._clamp(geom[3 + s] - geom[0], X) for s in (0, 1))
    gy = torch.arange(Y).view(Y, 1)
    gz = torch.arange(Z).view(1, Z)
    zero = torch.zeros(())
    nxt = torch.full_like(cur, float("nan"))
    inner = [torch.full(s, float("nan")) for s in tbf._plane_shapes(X, Y, Z)]
    below = _staged_row(cur, -1, src, mode, v_now)
    here = _staged_row(cur, 0, src, mode, v_now)
    for x in range(X):
        above = _staged_row(cur, x + 1, src, mode, v_now)
        acc = torch.zeros(Y, Z)
        for term in (below[1:-1, 1:-1], above[1:-1, 1:-1], here[:-2, 1:-1],
                     here[2:, 1:-1], here[1:-1, :-2], here[1:-1, 2:]):
            acc = acc + term
        bare, z_only = _warp_paths(geom, cur.shape, x, src, xin)
        p = prev[x].clone()
        leap = tbf.COURANT_SQ * acc - p
        # z only: the z inside test, the z splices, the z extractions
        z_in = (gz >= geom[7]) & (gz <= geom[8])
        res_z = torch.where(z_in, leap, zero)
        res_z = torch.where(gz == geom[7] - 1, planes[4][x][:, None], res_z)
        res_z = torch.where(gz == geom[8] + 1, planes[5][x][:, None], res_z)
        # general
        if halos is not None and x == 0:
            acc = acc + halos[0][0]
        if halos is not None and x == X - 1:
            acc = acc + halos[1][0]
        if src is not None and src[0] == x:
            p[sy, sz] = v_prev if mode == 1 else p[sy, sz] + v_prev
        gx = geom[0] + x
        inside = (geom[3] <= gx <= geom[4]) & (gy >= geom[5]) \
            & (gy <= geom[6]) & z_in
        res = torch.where(inside, tbf.COURANT_SQ * acc - p, zero)
        res = torch.where(gy == geom[5] - 1, planes[2][x][None, :], res)
        res = torch.where(gy == geom[6] + 1, planes[3][x][None, :], res)
        res = torch.where(gz == geom[7] - 1, planes[4][x][:, None], res)
        res = torch.where(gz == geom[8] + 1, planes[5][x][:, None], res)
        if gx == geom[3] - 1:
            res = planes[0].clone()
        if gx == geom[4] + 1:
            res = planes[1].clone()
        general = ~bare & ~z_only
        nxt[x] = torch.where(bare, leap, torch.where(z_only, res_z, res))
        for q, (axis, s_) in enumerate(tbf.PLANES):
            if axis == 0:
                if x == xin[s_]:
                    inner[q] = torch.where(general, res, inner[q])
                continue
            c = geom[3 + 2 * axis + s_]
            if axis == 1:
                line, keep = res[c], general[c]
            else:
                line = torch.where(z_only[:, c], res_z[:, c], res[:, c])
                keep = general[:, c] | z_only[:, c]
            inner[q][x] = torch.where(keep, line, inner[q][x])
        below, here = here, above
    return nxt, tuple(inner)


# (dims, x offset, rows, source (global x, y, z), mode)
ORDER_CASES = [
    # the (20, 16, 128) shard at offset 4 with halos, every injection mode
    ((20, 16, 128), 4, 16, (12, 9, 64), 0),
    ((20, 16, 128), 4, 16, (12, 9, 64), 1),
    ((20, 16, 128), 4, 16, (12, 9, 64), 2),
    # on the low inner x plane; on the inner corner
    ((20, 16, 128), 4, 16, (6, 7, 30), 2),
    ((20, 16, 128), 4, 16, (17, 13, 125), 1),
    # on a z warp edge, each side
    ((20, 16, 128), 4, 16, (12, 9, 31), 1),
    ((20, 16, 128), 4, 16, (12, 9, 32), 2),
    # in row 0 and row X - 1 of the shard
    ((20, 16, 128), 4, 16, (4, 9, 64), 1),
    ((20, 16, 128), 4, 16, (19, 9, 64), 2),
    # a source in the halo row below the shard injects nothing here
    ((20, 16, 128), 4, 16, (3, 9, 64), 1),
    # the unaligned box, a source on each side of a 16-row y edge
    ((37, 29, 53), 0, 37, (18, 14, 26), 2),
    ((37, 29, 53), 0, 37, (18, 15, 26), 1),
    ((37, 29, 53), 0, 37, (18, 16, 40), 2),
    # a shard inside the box in x: its rows 0 and X - 1 take the halos,
    # the source in row 0
    ((20, 16, 128), 8, 8, (8, 9, 64), 1),
    # a two-row shard of the unaligned box
    ((37, 29, 53), 20, 2, (21, 14, 26), 1),
]


@pytest.mark.parametrize("dims,x_off,rows,src,mode", ORDER_CASES)
def test_kernel_order_matches_plain(rng, dims, x_off, rows, src, mode):
    """The kernel's order of work and choice of warp paths in plain torch
    (``_row_walk_step``) equals ``_fused_step_plain`` to the bit, in
    ``next`` and the six inner planes."""
    lo = (2, 3, 2) if dims[1] == 29 else (2, 2, 2)
    spec = tbf.BoxSpec(dims=dims, ilo=(x_off and 6 or lo[0],) + lo[1:],
                       ihi=tuple(d - 3 for d in dims), face_surface=(0,) * 6)
    cur, prev, planes, halos, inj_val = (
        _to_torch(a) for a in _step_inputs(rng, (rows,) + dims[1:]))
    args = (spec.geom_array(x_offset=x_off), cur, prev, planes,
            src + (mode,), inj_val, halos if x_off else None)
    want_next, want_inner = tbf._fused_step_plain(*args)
    got_next, got_inner = _row_walk_step(*args)
    assert torch.equal(got_next, want_next)
    for q, (g, w) in enumerate(zip(got_inner, want_inner)):
        assert torch.equal(g, w), q


def _shifted(t, axis, d):
    """A (Y, Z) plane read at index + d along ``axis``: +0 where that lies
    off the plane."""
    out = torch.zeros_like(t)
    n = t.shape[axis] - abs(d)
    if n > 0:
        out.narrow(axis, max(-d, 0), n).copy_(t.narrow(axis, max(d, 0), n))
    return out


def _gtot_row(g, ginner, geom, x, rule):
    """Unmasked Gtot on row x by one of the kernel's rules
    (``mega_timing.B5_PATHS``): 0 bare (g + 0.f), 1 z only (g + 0.f, then
    the inner z cotangents where z lies on an inner z plane), 2 x only (g,
    the two inner x cotangents, + 0.f), 3 general (g and the six
    inner-plane adds)."""
    _, Y, Z = g.shape
    y = torch.arange(Y).view(Y, 1)
    z = torch.arange(Z).view(1, Z)
    if rule < 2:
        t = g[x] + 0.0
        if rule == 1:
            t = torch.where(z == geom[7], t + ginner[4][x][:, None], t)
            t = torch.where(z == geom[8], t + ginner[5][x][:, None], t)
        return t
    zero = torch.zeros(())
    gx = geom[0] + x
    t = g[x]
    if rule == 2:
        t = t + (ginner[0] if gx == geom[3] else zero)
        return t + (ginner[1] if gx == geom[4] else zero) + 0.0
    t = t + (ginner[0] if gx == geom[3] else zero)
    t = t + (ginner[1] if gx == geom[4] else zero)
    t = t + torch.where(y == geom[5], ginner[2][x][None, :], zero)
    t = t + torch.where(y == geom[6], ginner[3][x][None, :], zero)
    t = t + torch.where(z == geom[7], ginner[4][x][:, None], zero)
    t = t + torch.where(z == geom[8], ginner[5][x][:, None], zero)
    return t


def _row_walk_step_bwd(geom, g, ginner, inj_idx):
    """The adjoint computed as the CUDA kernel B5 computes it: threads of
    (y, z) nodes walking ``BWD_WALK`` x rows with Gtot at x − 1, x and x + 1
    carried from row to row, each built by the rule of the row that loads
    it (a walk's first two by its first row's), and each node's row on the
    path of its warp (``mega_timing.b5_node_paths``): bare (the six g
    summed, gprev = −(g + 0.f)), z only (the z tests and z planes only), x
    only (the row's tests only) or general.  Unwritten elements stay NaN.  Returns (gcur, gprev, gplanes6,
    (ghlo, ghhi))."""
    from wayverb_tpu_torch.tools.mega_timing import b5_node_paths
    X, Y, Z = g.shape
    third = torch.tensor(tbf.COURANT_SQ, dtype=torch.float32)
    zero = torch.zeros(())
    y = torch.arange(Y).view(Y, 1)
    z = torch.arange(Z).view(1, Z)
    ilo0, ihi0, ilo1, ihi1, ilo2, ihi2 = geom[3:9]
    blo0, bhi0 = ilo0 - 1, ihi0 + 1
    paths = b5_node_paths(geom, (X, Y, Z), inj_idx)
    sx, sy, sz, mode = inj_idx
    src = (sx - geom[0], sy, sz) if mode == 1 else None
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    gcur, gprev = nan(X, Y, Z), nan(X, Y, Z)
    gpl = [nan(*s) for s in tbf._plane_shapes(X, Y, Z)]
    ghlo, ghhi = nan(1, Y, Z), nan(1, Y, Z)

    def by_path(x, path):
        # Gtot on row x, each node's by its own path's rule
        rows = [_gtot_row(g, ginner, geom, x, r) for r in range(4)]
        out = rows[3]
        for r in (2, 1, 0):
            out = torch.where(path == r, rows[r], out)
        return out

    def in_box(gx):
        return ((ilo0 <= gx <= ihi0) & (y >= ilo1) & (y <= ihi1) & (z >= ilo2)
                & (z <= ihi2))

    for x in range(X):
        path = paths[x]
        if x % tbf.BWD_WALK == 0:
            gm = by_path(x - 1, path) if x > 0 else torch.zeros(Y, Z)
            g0 = by_path(x, path)
        gp = by_path(x + 1, path) if x + 1 < X else torch.zeros(Y, Z)
        gx = geom[0] + x
        # bare
        acc = torch.zeros(Y, Z)
        for term in (gm, gp, _shifted(g[x], 0, -1), _shifted(g[x], 0, 1),
                     _shifted(g[x], 1, -1), _shifted(g[x], 1, 1)):
            acc = acc + term
        cur_b, prev_b = third * acc, -g0
        # z only
        zt = _gtot_row(g, ginner, geom, x, 1)
        zin = (z >= ilo2) & (z <= ihi2)
        acc = torch.zeros(Y, Z)
        for term in (torch.where(zin, gm, zero), torch.where(zin, gp, zero),
                     torch.where(zin, _shifted(zt, 0, -1), zero),
                     torch.where(zin, _shifted(zt, 0, 1), zero),
                     torch.where((z - 1 >= ilo2) & (z - 1 <= ihi2),
                                 _shifted(zt, 1, -1), zero),
                     torch.where((z + 1 >= ilo2) & (z + 1 <= ihi2),
                                 _shifted(zt, 1, 1), zero)):
            acc = acc + term
        cur_z, prev_z = third * acc, -torch.where(zin, g0, zero)
        # x only: the row's inside tests; y and z neighbours only inside
        in_0 = ilo0 <= gx <= ihi0
        acc = torch.zeros(Y, Z)
        xt = _gtot_row(g, ginner, geom, x, 2)
        for term in ((gm if x > 0 and ilo0 <= gx - 1 <= ihi0 else zero),
                     (gp if x + 1 < X and ilo0 <= gx + 1 <= ihi0 else zero)):
            acc = acc + term
        if in_0:
            for term in (_shifted(xt, 0, -1), _shifted(xt, 0, 1),
                         _shifted(xt, 1, -1), _shifted(xt, 1, 1)):
                acc = acc + term
        cur_x, prev_x = third * acc, -(g0 if in_0 else torch.zeros(Y, Z))
        # general
        inside = in_box(gx)
        gen = torch.where(inside, _gtot_row(g, ginner, geom, x, 3), zero)
        acc = torch.zeros(Y, Z)
        for term in (torch.where((x > 0) & in_box(gx - 1), gm, zero),
                     torch.where((x + 1 < X) & in_box(gx + 1), gp, zero),
                     _shifted(gen, 0, -1), _shifted(gen, 0, 1),
                     _shifted(gen, 1, -1), _shifted(gen, 1, 1)):
            acc = acc + term
        G = torch.where(inside, g0, zero)
        cur_g, prev_g = third * acc, -G
        if src is not None and src[0] == x:
            cur_g[src[1], src[2]] = prev_g[src[1], src[2]] = 0.0
        for out, by in ((gcur, (cur_b, cur_z, cur_x, cur_g)),
                        (gprev, (prev_b, prev_z, prev_x, prev_g))):
            row = by[3]
            for r in (2, 1, 0):
                row = torch.where(path == r, by[r], row)
            out[x] = row
        # planes, from the general nodes, the z-only nodes for z and the
        # x-only nodes for x and the halos
        general = path == 3
        x_rows = general | (path == 2)
        on_x = gx in (blo0, bhi0)
        if gx == blo0:
            gpl[0] = torch.where(x_rows, g0, gpl[0])
        if gx == bhi0:
            gpl[1] = torch.where(x_rows, g0, gpl[1])
        on_z = (z == ilo2 - 1) | (z == ihi2 + 1)
        for q, c in ((2, ilo1 - 1), (3, ihi1 + 1)):
            val = torch.where(on_z[0] | on_x, zero, g0[c])
            gpl[q][x] = torch.where(general[c], val, gpl[q][x])
        for q, c in ((4, ilo2 - 1), (5, ihi2 + 1)):
            val = torch.where(general[:, c], zero if on_x else g0[:, c],
                              torch.where(path[:, c] == 1, g0[:, c],
                                          gpl[q][x]))
            gpl[q][x] = val
        if x == 0:
            for q, b in ((0, blo0), (1, bhi0)):
                if not 0 <= b - geom[0] < X:
                    gpl[q] = torch.where(x_rows, zero, gpl[q])
            ghlo[0] = torch.where(x_rows, third * G, ghlo[0])
        if x == X - 1:
            ghhi[0] = torch.where(x_rows, third * G, ghhi[0])
        gm, g0 = g0, gp
    return gcur, gprev, tuple(gpl), (ghlo, ghhi)


# (dims, x offset, rows, source (global x, y, z), mode, cotangents)
BWD_ORDER_CASES = [case + ("random",) for case in ORDER_CASES] + [
    ((20, 16, 128), 4, 16, (12, 9, 64), 1, "all -0"),
    ((37, 29, 53), 20, 2, (21, 14, 26), 1, "all -0"),
    ((37, 29, 53), 0, 37, (18, 14, 26), 2, "1e38 inf nan"),
    ((20, 16, 128), 8, 1, (8, 9, 64), 1, "1e38 inf nan"),
]


@pytest.mark.parametrize("dims,x_off,rows,src,mode,kind", BWD_ORDER_CASES)
def test_adjoint_kernel_order_matches_plain(dims, x_off, rows, src, mode,
                                            kind):
    """B5's order of work and choice of warp paths in plain torch
    (``_row_walk_step_bwd``) equals ``_fused_step_bwd_plain`` to the bit
    (``bits_equal``: −0 apart from +0, NaN for NaN) in gcur, gprev, the six
    plane cotangents and both halo cotangents."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal, case_g
    lo = (2, 3, 2) if dims[1] == 29 else (2, 2, 2)
    spec = tbf.BoxSpec(dims=dims, ilo=(x_off and 6 or lo[0],) + lo[1:],
                       ihi=tuple(d - 3 for d in dims), face_surface=(0,) * 6)
    gen = torch.Generator().manual_seed(sum(src) + mode)
    shape = (rows,) + dims[1:]
    g = case_g(kind, shape, gen)
    ginner = tuple(case_g(kind, s, gen) for s in tbf._plane_shapes(*shape))
    args = (spec.geom_array(x_offset=x_off), g, ginner, src + (mode,))
    flat = lambda r: (r[0], r[1], *r[2], *r[3])  # noqa: E731
    got = flat(_row_walk_step_bwd(*args))
    want = flat(tbf._fused_step_bwd_plain(*args))
    for q, (a, b) in enumerate(zip(got, want)):
        assert bits_equal(a, b), q


def _to_torch(a):
    if isinstance(a, list):
        return tuple(torch.from_numpy(x) for x in a)
    return torch.from_numpy(a)


@pytest.mark.parametrize("which", ["cur", "prev", "plane", "halo"])
def test_fused_step_refuses_out_that_overlaps_an_input(rng, which):
    """``out`` may not share memory with an input, on any device: the CUDA
    kernel writes ``next`` through a restrict pointer."""
    spec = tbf.BoxSpec(**GLOBAL)
    cur, prev, planes, halos, _ = (
        _to_torch(a) for a in _step_inputs(rng, GLOBAL["dims"]))
    out = torch.zeros(GLOBAL["dims"])
    if which == "cur":
        out = cur
    elif which == "prev":
        out = prev
    elif which == "plane":
        planes = (out[3],) + planes[1:]
    else:
        halos = (halos[0], out[5:6])
    with pytest.raises(ValueError, match="overlap"):
        tbf.fused_step(spec.geom_array(), cur, prev, planes, halos=halos,
                       out=out)
