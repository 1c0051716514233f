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
