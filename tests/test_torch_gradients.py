"""The port's gradient path against the JAX reference, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX functions
and the port's.  The reference's Pallas kernels run with ``interpret=True``
(as ``tests/test_box_fused.py`` and ``tests/test_box_mega.py`` run them);
the port's wrappers run their plain versions, because the tensors lie on the
CPU.  The CUDA kernels are held against the same plain versions on a GPU, in
``tests/test_torch_kernels.py``.

- B5: ``fused_step_bwd`` against ``jax.vjp`` of the reference's
  ``fused_step`` (atol 1e-6) and f64 ``gradcheck`` of the Function.
- B6: the residual block of ``mega_chunk(grad=True)`` against the seventh
  output of the reference's grad-mode chunk (atol 1e-6).
- B7: ``mega_chunk_bwd`` against the reference's backward chunk on random
  cotangents, each output within 1e-5 of its largest value.
- The whole path: gradients of Σ taps² through ``mega_canonical_loss_fn``
  against ``jax.grad`` through the reference's, and against the port's own
  fused path, relative bound 1e-4 (``tests/test_box_mega.py``'s).
- The checks of ``tests/test_gradients.py`` on the port, each against
  ``jax.grad`` of the reference (finite differences alone are not trusted).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core.geometry import Box as JBox, box_scene as jbox_scene
from wayverb_tpu.imagesource import exact as j_exact
from wayverb_tpu.waveguide import box_fused as jbf
from wayverb_tpu.waveguide import box_mega as jbm
from wayverb_tpu.waveguide import receivers as j_rcv
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide import sources as j_src
from wayverb_tpu.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core.geometry import Box as TBox
from wayverb_tpu_torch.imagesource import exact as t_exact
from wayverb_tpu_torch.waveguide import box_fused as tbf
from wayverb_tpu_torch.waveguide import box_mega as tbm
from wayverb_tpu_torch.waveguide import receivers as t_rcv
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import sources as t_src

torch.set_num_threads(2)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)
SRC, RCV = (0.7, 0.8, 0.5), (0.7, 0.8, 1.3)


def _carry_across(jm):
    """The port's Mesh on the CPU with the reference mesh's tables."""
    d, s = jm.descriptor, jm.box_spec
    return convert.mesh_from_numpy({
        "min_corner": np.asarray(d.min_corner),
        "dimensions": np.asarray(d.dimensions), "spacing": d.spacing,
        "inside": np.asarray(jm.inside),
        "coef_b": np.asarray(jm.structure.coef_b),
        "coef_a": np.asarray(jm.structure.coef_a),
        "room_volume": jm.room_volume,
        "box_dims": np.asarray(s.dims), "box_ilo": np.asarray(s.ilo),
        "box_ihi": np.asarray(s.ihi),
        "box_face_surface": np.asarray(s.face_surface)}, device="cpu")


@pytest.fixture(scope="module")
def meshes():
    """test_box_mega.py's small_mesh (aligned (8, 8, 128)) in both packages."""
    box = JBox((0, 0, 0), (1.4, 1.6, 1.8))
    jm = j_run.compute_mesh(jbox_scene(box), np.full((1, 8), 0.12), DX, FS,
                            scene_box=box, align=(8, 8, 128))
    return jm, _carry_across(jm)


@pytest.fixture(scope="module")
def grad_meshes():
    """test_gradients.py's box (1.2 × 1.3 × 1.4 m, absorption 0.3)."""
    jm = j_run.shoebox_mesh(JBox((0, 0, 0), (1.2, 1.3, 1.4)),
                            np.full((1, 8), 0.3), DX, FS)
    return jm, _carry_across(jm)


def _t(x, **kw):
    return torch.tensor(np.asarray(x), **kw)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / (np.max(np.abs(want)) + 1e-30))


# ---------------------------------------------------------------------------
# B5: the fused step's adjoint

def _step_problem(rng, dims=(16, 16, 128), rows=None):
    """Random cotangents and the box of tests/test_box_fused.py; ``rows``:
    (first, count) local x rows of a shard."""
    inside = np.zeros(dims, dtype=bool)
    inside[2:-2, 2:-2, 2:-2] = True
    jspec = jbf.spec_from_inside(inside)
    tspec = tbf.spec_from_inside(inside)
    off, X = rows or (0, dims[0])
    shape = (X,) + dims[1:]
    mk = lambda s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    g = mk(shape)
    ginner = [mk(s) for s in tbf._plane_shapes(*shape)]
    return jspec, tspec, off, g, ginner


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("case,rows,src", [
    ("no source", None, (8, 9, 64, 0)),
    ("hard source", None, (8, 9, 64, 1)),
    ("soft source", None, (2, 4, 64, 2)),
    ("x offset, both x planes elsewhere", (8, 8), (11, 9, 64, 1)),
    ("x offset, owns the high x plane", (8, 8), (12, 9, 64, 1)),
])
def test_fused_step_bwd_matches_jax_vjp(rng, interpret, case, rows, src):
    """``fused_step_bwd`` against ``jax.vjp`` of the reference's
    ``fused_step`` (the interpreted Pallas backward and the jnp backward) on
    random g and ginner; atol 1e-6."""
    dims = (16, 16, 128)
    if case == "x offset, both x planes elsewhere":
        dims = (32, 16, 128)
    jspec, tspec, off, g, ginner = _step_problem(rng, dims, rows)
    shape = g.shape
    zeros = lambda s: jnp.zeros(s, jnp.float32)  # noqa: E731
    jplanes = tuple(zeros(s) for s in tbf._plane_shapes(*shape))
    jhalos = (zeros((1,) + shape[1:]), zeros((1,) + shape[1:]))
    inj_idx = jnp.asarray(src, jnp.int32)
    inj_val = jnp.asarray([0.3, -0.2], jnp.float32)

    def step(cur, prev, planes, halos):
        return jbf.fused_step(jspec, jspec.geom_array(x_offset=off), cur,
                              prev, planes, inj_idx, inj_val, halos,
                              interpret)

    _, pullback = jax.vjp(step, zeros(shape), zeros(shape), jplanes, jhalos)
    want = pullback((jnp.asarray(g), tuple(map(jnp.asarray, ginner))))
    got = tbf.fused_step_bwd(tspec.geom_array(off), _t(g),
                             tuple(map(_t, ginner)), tuple(src))
    pairs = [(got[0], want[0]), (got[1], want[1]),
             *zip(got[2], want[2]), *zip(got[3], want[3])]
    assert len(pairs) == 10
    for mine, ref in pairs:
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    if src[3] == 1:
        lx = src[0] - off
        assert float(got[0][lx, src[1], src[2]]) == 0.0
        assert float(got[1][lx, src[1], src[2]]) == 0.0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fused_step_function_gradcheck_f64(mode):
    """f64 ``gradcheck`` of the Function around ``fused_step`` (forward and
    backward through the plain versions) on an unaligned shard with an x
    offset and halos.  A hard source's node is cut off from cur and prev in
    the forward too, so the check holds in every mode."""
    spec = tbf.BoxSpec(dims=(13, 9, 11), ilo=(6, 3, 2), ihi=(9, 5, 8),
                       face_surface=(0,) * 6)
    off, X = 4, 8                      # global rows 4..11: owns every plane
    _, Y, Z = spec.dims
    gen = torch.Generator().manual_seed(5)
    mk = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64,  # noqa
                                requires_grad=True)
    cur, prev = mk(X, Y, Z), mk(X, Y, Z)
    planes = tuple(mk(*s) for s in tbf._plane_shapes(X, Y, Z))
    halos = (mk(1, Y, Z), mk(1, Y, Z))
    inj_val = torch.tensor([0.7, -0.4], dtype=torch.float64)
    geom = spec.geom_array(off)

    def f(cur, prev, hlo, hhi, *planes):
        nxt, inner = tbf.fused_step(geom, cur, prev, planes, (7, 4, 5, mode),
                                    inj_val, (hlo, hhi))
        assert nxt.grad_fn is not None and "FusedStep" in type(
            nxt.grad_fn).__name__
        return (nxt, *inner)

    assert torch.autograd.gradcheck(f, (cur, prev, *halos, *planes))


def test_fused_step_function_is_on_the_route(monkeypatch):
    """A tensor that requires grad goes through the Function, whose backward
    is ``fused_step_bwd`` (a stub stands in and is reached), never through
    autograd of the plain forward; ``out=`` is refused; nothing that
    requires grad means the direct route, no graph."""
    spec = tbf.BoxSpec(dims=(9, 9, 11), ilo=(2, 3, 2), ihi=(6, 5, 8),
                       face_surface=(0,) * 6)
    geom = spec.geom_array()
    cur = torch.randn(spec.dims, requires_grad=True)
    prev = torch.randn(spec.dims)
    planes = tuple(torch.randn(s) for s in tbf._plane_shapes(*spec.dims))
    calls = []
    real = tbf.fused_step_bwd

    def stub(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tbf, "fused_step_bwd", stub)
    nxt, inner = tbf.fused_step(geom, cur, prev, planes)
    (nxt.sum() + inner[2].sum()).backward()
    assert len(calls) == 1 and cur.grad is not None
    with pytest.raises(ValueError, match="out="):
        tbf.fused_step(geom, cur, prev, planes, out=torch.empty(spec.dims))
    nxt, _ = tbf.fused_step(geom, cur.detach(), prev, planes)
    assert nxt.grad_fn is None and len(calls) == 1
    with torch.no_grad():
        nxt, _ = tbf.fused_step(geom, cur, prev, planes)
    assert not nxt.requires_grad
    with pytest.raises(ValueError, match="device"):
        tbf.fused_step_bwd(geom, torch.zeros(spec.dims, device="meta"),
                           planes)


# ---------------------------------------------------------------------------
# B6 and B7: one chunk against the reference's interpreted kernels

def _chunk_problem(jm, tm, rng, src, taps, K=4, consistent=True):
    """One chunk's inputs for both packages.  ``consistent``: the state of a
    run (fields, filter state and carried planes after 4 sub-steps from rest)
    rather than zeros, so every residual role is exercised."""
    jspec, tspec = jm.box_spec, tm.box_spec
    order = tm.structure.filter_order
    Umax, Vmax = tbf.stacked_plane_shape(tspec)
    fb, fa = tbf.face_coefficients(tm.structure, tspec)
    tap_idx = torch.tensor([np.ravel_multi_index(t, tspec.dims)
                            for t in taps])
    state = (torch.zeros(tspec.dims), torch.zeros(tspec.dims),
             torch.zeros(order, 6, Umax, Vmax),
             torch.zeros(3, 6, Umax, Vmax))
    if consistent:
        warm = _t(rng.normal(size=4).astype(np.float32))
        state = tbm.mega_chunk(tspec, warm, fb, fa, *state, src,
                               tap_idx)[:4]
    sig = rng.normal(size=K).astype(np.float32)
    return dict(jspec=jspec, tspec=tspec, order=order, fb=fb, fa=fa,
                tap_idx=tap_idx, taps=taps, state=state, sig=sig, K=K,
                src=src)


CHUNK_CASES = [
    # (source x, y, z offsets from ilo, mode, tap at the source?)
    ("hard source", (5, 6, 40), 1, False),
    ("soft source on the inner x plane, tap at the source", (0, 6, 40), 2,
     True),
    ("hard source on the inner z plane", (5, 6, 0), 1, True),
]


def _case_src_taps(spec, offs, mode, tap_at_source):
    src = tuple(spec.ilo[a] + offs[a] for a in range(3))
    taps = [(src[0] + 2, src[1], src[2] + 1), (spec.ilo[0], spec.ilo[1] + 1,
                                               spec.ihi[2])]
    if tap_at_source:
        taps.insert(0, src)
    return src + (mode,), tuple(taps)


@pytest.mark.parametrize("case,offs,mode,tap_at_source", CHUNK_CASES)
def test_mega_chunk_grad_mode_matches_jax(meshes, rng, case, offs, mode,
                                          tap_at_source):
    """B6: the residual block (PL, INS after the injection patch, PRVP, the
    old first state slot) against the seventh output of the reference's
    grad-mode chunk, atol 1e-6; the other outputs equal ``grad=False``'s
    exactly."""
    jm, tm = meshes
    src, taps = _case_src_taps(tm.box_spec, offs, mode, tap_at_source)
    p = _chunk_problem(jm, tm, rng, src, taps)
    args = (p["tspec"], _t(p["sig"]), p["fb"], p["fa"], *p["state"], src,
            p["tap_idx"])
    plain = tbm.mega_chunk(*args)
    got = tbm.mega_chunk(*args, grad=True)
    assert len(plain) == 6 and len(got) == 7
    for a, b in zip(plain, got[:6]):
        assert torch.equal(a, b)
    gcall = jbm._build_call(p["jspec"], p["K"], len(taps), p["order"], src,
                            taps, grad=True, interpret=True)
    want = gcall(jnp.asarray(p["sig"]), jnp.asarray(p["fb"].numpy()),
                 jnp.asarray(p["fa"].numpy()),
                 *(jnp.asarray(s.numpy()) for s in p["state"]))
    assert tuple(got[6].shape) == tuple(want[6].shape)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]), rtol=0,
                               atol=1e-6)
    # the patched INS really differs from the carried one at the source
    ins_targets = tbm._inner_plane_source(p["tspec"], src)
    if ins_targets:
        pi, u, v = ins_targets[0]
        want_in = p["sig"][0] if mode == 1 else \
            float(p["state"][3][1, pi, u, v]) + p["sig"][0]
        assert abs(float(got[6][0, 1, pi, u, v]) - want_in) < 1e-6
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("case,offs,mode,tap_at_source", CHUNK_CASES)
def test_mega_chunk_bwd_matches_jax(meshes, rng, case, offs, mode,
                                    tap_at_source):
    """B7: one chunk of the adjoint against the reference's backward chunk
    (interpret mode) on random cotangents; each of the six outputs within
    1e-5 of its largest value, and per plane for the two streams (a slip in
    the splice precedence shows on single edge lines)."""
    jm, tm = meshes
    tspec = tm.box_spec
    src, taps = _case_src_taps(tspec, offs, mode, tap_at_source)
    p = _chunk_problem(jm, tm, rng, src, taps, consistent=False)
    K, order = p["K"], p["order"]
    Umax, Vmax = tbf.stacked_plane_shape(tspec)
    mask = np.zeros((6, Umax, Vmax), np.float32)
    for q in range(6):
        U, V = tspec.plane_shape(q)
        mask[q, :U, :V] = 1.0
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    gtaps = mk(K, len(taps))
    gnext, gcur = mk(*tspec.dims), mk(*tspec.dims)
    gst = mk(order, 6, Umax, Vmax) * mask
    got = tbm.mega_chunk_bwd(tspec, p["fb"], p["fa"], _t(gtaps), _t(gnext),
                             _t(gcur), _t(gst), src, p["tap_idx"])
    bcall = jbm._build_bwd_call(p["jspec"], K, len(taps), order, src, taps,
                                interpret=True)
    want = bcall(jnp.asarray(p["fb"].numpy()), jnp.asarray(p["fa"].numpy()),
                 *(jnp.asarray(x) for x in (gtaps, gnext, gcur, gst)))
    names = ("gnext", "gcur", "gst", "gsig")
    assert len(got) == len(want) == 6
    for name, mine, ref in zip(names, got, want):
        ref = np.asarray(ref).reshape(mine.shape)
        assert _rel(mine.numpy(), ref) <= 1e-5, name
    # the streams plane by plane, over each plane's own (U, V): the
    # reference never writes the padding of its ĝpplus scratch (the
    # interpreter leaves NaN there); the port writes zeros
    for name, mine, ref, axis in (("gp_stream", got[4], want[4], 1),
                                  ("gstin_stream", got[5], want[5], 2)):
        ref = np.asarray(ref)
        assert tuple(mine.shape) == ref.shape
        crop = [np.take(ref, q, axis=axis)[..., :U, :V] for q, (U, V) in
                enumerate(tspec.plane_shape(q) for q in range(6))]
        scale = max(float(np.max(np.abs(c))) for c in crop)
        for q in range(6):
            U, V = tspec.plane_shape(q)
            a = mine.select(axis, q).numpy()
            assert float(np.max(np.abs(a[..., :U, :V] - crop[q]))) <= \
                1e-5 * scale, (name, q)
            assert not a[..., U:, :].any() and not a[..., :, V:].any()
    if mode == 0:
        assert float(got[3].abs().max()) == 0.0


def test_mega_chunk_bwd_matches_autograd_of_the_plain_chunk():
    """The adjoint's structure, independent of the reference: two chained
    chunks of ``mega_chunk_bwd`` reproduce autograd through the plain
    forward chunks in f64, for a run from rest (where the carried planes are
    copies of field values); relative bound 1e-9."""
    spec = tbf.BoxSpec(dims=(11, 10, 13), ilo=(2, 3, 2), ihi=(8, 6, 10),
                       face_surface=(0,) * 6)
    order, K = 3, 4
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.rand(*s, generator=gen, dtype=f64)  # noqa: E731
    fb = torch.tensor([[2.0, 0.2, 0.1, 0.04]] * 6, dtype=f64) + 0.1 * rnd(6, 4)
    fa = torch.tensor([[1.0, -0.2, 0.01, 0.03]] * 6, dtype=f64) \
        + 0.05 * rnd(6, 4)
    src = (2, 4, 6, 2)                       # soft, on the inner x plane
    flat = (src[0] * spec.dims[1] + src[1]) * spec.dims[2] + src[2]
    taps = torch.tensor([flat, flat + 1, flat + 130, 200])
    sig = rnd(2 * K) - 0.5
    w = rnd(2 * K, 4) - 0.5
    zeros = lambda *s: torch.zeros(*s, dtype=f64)  # noqa: E731

    ins = [t.clone().requires_grad_(True) for t in (fb, fa, sig)]
    state = (zeros(spec.dims), zeros(spec.dims), zeros(order, 6, Umax, Vmax),
             zeros(3, 6, Umax, Vmax))
    blocks, residuals = [], []
    for c in range(2):
        out = tbm._mega_chunk_plain(spec, ins[2][c * K:(c + 1) * K], ins[0],
                                    ins[1], *state, src, taps, grad=True)
        state = out[:4]
        blocks.append(out[4])
        residuals.append(out[6].detach())
    want = torch.autograd.grad((torch.cat(blocks) * w).sum(), ins)

    carry = (zeros(spec.dims), zeros(spec.dims), zeros(order, 6, Umax, Vmax))
    gfb, gfa, gsig = torch.zeros_like(fb), torch.zeros_like(fa), [None, None]
    for c in (1, 0):
        *carry, gsig[c], gp_s, gstin_s = tbm.mega_chunk_bwd(
            spec, fb, fa, w[c * K:(c + 1) * K], *carry, src, taps)
        a, b = tbm._chunk_theta_grads(spec, fb, fa, residuals[c], gp_s,
                                      gstin_s)
        gfb += a
        gfa += b
    for mine, ref in zip((gfb, gfa, torch.cat(gsig)), want):
        assert _rel(mine.numpy(), ref.numpy()) <= 1e-9


# ---------------------------------------------------------------------------
# the whole path

def _point_problem(jm, tm, steps, kind, amp=3.0):
    desc = jm.descriptor
    node = desc.flat_index(jm.require_inside(SRC))
    rnode = desc.flat_index(jm.require_inside(RCV))
    jcls, tcls = ((j_src.HardSource, t_src.HardSource) if kind == "hard"
                  else (j_src.SoftSource, t_src.SoftSource))
    jsource = jcls(node_idx=jnp.asarray(node, jnp.int32),
                   signal=j_src.impulse_signal(steps, amp))
    tsource = tcls(node_idx=node,
                   signal=t_src.impulse_signal(steps, amp, "cpu"))
    return (jsource, j_rcv.NodeReceiver(jnp.asarray(rnode, jnp.int32)),
            tsource, t_rcv.NodeReceiver(torch.tensor(rnode)))


def _leaf(x):
    return torch.tensor(np.asarray(x)).requires_grad_(True)


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_mega_gradients_match_jax_and_the_fused_path(meshes, kind):
    """Gradients of Σ taps² with respect to coef_b, coef_a and the signal
    through the port's ``mega_canonical_loss_fn`` (chunk 4, 12 steps: the
    plain B6 and B7) against ``jax.grad`` through the reference's
    (interpreted kernels), and against the port's own fused path with
    ``kernel_inject=False``; relative bound 1e-4."""
    jm, tm = meshes
    steps = 12
    js, jr, ts, tr = _point_problem(jm, tm, steps, kind)
    jspec, tspec = jm.box_spec, tm.box_spec
    face_idx = np.asarray(jspec.face_surface)
    jf = jbm.mega_canonical_loss_fn(jm.structure, jspec, js, jr, steps,
                                    chunk=4, interpret=True)

    def jloss(coef_b, coef_a, sig):
        taps, _ = jf(coef_b[face_idx], coef_a[face_idx], sig)
        return jnp.sum(taps ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jm.structure.coef_b, jm.structure.coef_a, js.signal)

    launches = (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches,
                tbm.mega_chunk_bwd.launches)
    cb, ca = _leaf(jm.structure.coef_b), _leaf(jm.structure.coef_a)
    sig = _leaf(js.signal)
    tf = tbm.mega_canonical_loss_fn(tm.structure, tspec, ts, tr, steps,
                                    chunk=4)
    structure = dataclasses.replace(tm.structure, coef_b=cb, coef_a=ca)
    taps, stable = tf(*tbf.face_coefficients(structure, tspec), sig)
    assert tuple(taps.shape) == (steps, 1) and bool(stable)
    assert not stable.requires_grad
    torch.sum(taps ** 2).backward()
    got = (cb.grad, ca.grad, sig.grad)
    for mine, ref in zip(got, want):
        assert _rel(mine.numpy(), ref) < 1e-4

    cb2, ca2, sig2 = (_leaf(x.detach().numpy()) for x in (cb, ca, sig))
    out = t_run.run_waveguide_box(
        dataclasses.replace(tm.structure, coef_b=cb2, coef_a=ca2), tspec,
        dataclasses.replace(ts, signal=sig2), tr, steps, kernel_inject=False)
    torch.sum(out["outputs"] ** 2).backward()
    for mine, ref in zip(got, (cb2.grad, ca2.grad, sig2.grad)):
        assert _rel(mine.numpy(), ref.numpy()) < 1e-4
    # no kernel was launched: CPU tensors run the plain versions
    assert launches == (tbm.mega_chunk.launches,
                        tbm.mega_chunk.grad_launches,
                        tbm.mega_chunk_bwd.launches)


def test_run_waveguide_box_mega_differentiates(meshes):
    """``run_waveguide_box_mega`` goes through the same Function: a loss on
    its directional-receiver outputs gives the gradients of the fused path
    (``kernel_inject=False``), relative bound 1e-4; with nothing requiring
    grad the plain chunk runs (no residuals) and the result has no graph."""
    jm, tm = meshes
    steps = 10
    desc = tm.descriptor
    _, _, ts, _ = _point_problem(jm, tm, steps, "hard")
    tr = t_rcv.make_directional_receiver(
        desc, desc.sample_rate(340.0), 1.225,
        desc.position(tm.require_inside(RCV)), "cpu")
    grads = []
    for runner in ("mega", "fused"):
        cb = _leaf(tm.structure.coef_b.numpy())
        sig = _leaf(ts.signal.numpy())
        structure = dataclasses.replace(tm.structure, coef_b=cb)
        source = dataclasses.replace(ts, signal=sig)
        if runner == "mega":
            out = tbm.run_waveguide_box_mega(structure, tm.box_spec, source,
                                             tr, steps, chunk=4)
        else:
            out = t_run.run_waveguide_box(structure, tm.box_spec, source, tr,
                                          steps, kernel_inject=False)
        intensity, pressure = out["outputs"]
        (torch.sum(pressure ** 2) + 1e3 * torch.sum(intensity ** 2)
         ).backward()
        grads.append((cb.grad, sig.grad))
    for mine, ref in zip(*grads):
        assert _rel(mine.numpy(), ref.numpy()) < 1e-4

    seen = []
    real = tbm.mega_chunk

    def spy(*args, **kwargs):
        seen.append(kwargs.get("grad", False))
        return real(*args, **kwargs)

    try:
        tbm.mega_chunk = spy
        out = tbm.run_waveguide_box_mega(tm.structure, tm.box_spec, ts, tr,
                                         steps, chunk=4)
    finally:
        tbm.mega_chunk = real
    assert seen == [False] * 3
    assert not out["outputs"][1].requires_grad


def test_default_inject_gradient_equals_kernel_inject_false(meshes):
    """With a hard source the material gradient through the default route
    (injection inside the fused step, the B5 Function) equals the gradient
    through ``kernel_inject=False`` (``tests/test_box_fused.py``'s check,
    rtol 1e-4), and equals ``jax.grad`` of the reference's default route;
    the signal gradient of the default route stops at the hard source."""
    jm, tm = meshes
    steps = 30
    js, jr, ts, tr = _point_problem(jm, tm, steps, "hard", amp=1.0)

    def jloss(coef_b):
        s = dataclasses.replace(jm.structure, coef_b=coef_b)
        out = j_run.run_waveguide_box(s, jm.box_spec, js, jr, steps)
        return jnp.sum(out["outputs"] ** 2)

    want = np.asarray(jax.grad(jloss)(jm.structure.coef_b))
    grads = {}
    for inject in (True, False):
        cb = _leaf(tm.structure.coef_b.numpy())
        sig = _leaf(ts.signal.numpy())
        out = t_run.run_waveguide_box(
            dataclasses.replace(tm.structure, coef_b=cb), tm.box_spec,
            dataclasses.replace(ts, signal=sig), tr, steps,
            kernel_inject=inject)
        torch.sum(out["outputs"] ** 2).backward()
        grads[inject] = (cb.grad.numpy(), sig.grad.numpy())
    np.testing.assert_allclose(grads[True][0], grads[False][0], rtol=1e-4,
                               atol=1e-8)
    assert _rel(grads[True][0], want) < 1e-4
    assert np.any(grads[False][1] != 0)
    assert np.max(np.abs(grads[True][1])) < np.max(np.abs(grads[False][1]))


def test_signal_only_gradient_of_the_default_route_is_zero(meshes):
    """Only the source signal requires grad, the injection is inside the
    fused step and the source lies off the inner planes and the receiver:
    the run still has a graph, and the signal gradient is the reference's
    zero (the step's injection values get a zero gradient)."""
    jm, tm = meshes
    steps = 12
    js, jr, ts, tr = _point_problem(jm, tm, steps, "hard")

    def jloss(sig):
        out = j_run.run_waveguide_box(
            jm.structure, jm.box_spec, dataclasses.replace(js, signal=sig),
            jr, steps)
        return jnp.sum(out["outputs"] ** 2)

    want = np.asarray(jax.grad(jloss)(js.signal))
    assert not np.any(want)
    sig = _leaf(ts.signal.numpy())
    out = t_run.run_waveguide_box(
        tm.structure, tm.box_spec, dataclasses.replace(ts, signal=sig), tr,
        steps)
    assert out["outputs"].requires_grad
    torch.sum(out["outputs"] ** 2).backward()
    np.testing.assert_array_equal(sig.grad.numpy(), want)


def test_mega_backward_skips_theta_and_refuses_a_second_pass(meshes):
    """With only the signal requiring grad the mega backward never builds
    the coefficient gradients, and the signal gradient is the one of the
    run in which everything requires grad; a second backward over the same
    graph raises for the freed residuals."""
    jm, tm = meshes
    steps = 12
    _, _, ts, tr = _point_problem(jm, tm, steps, "soft")
    tf = tbm.mega_canonical_loss_fn(tm.structure, tm.box_spec, ts, tr, steps,
                                    chunk=4)
    fb, fa = tbf.face_coefficients(tm.structure, tm.box_spec)

    fbl, fal, sig_all = _leaf(fb.numpy()), _leaf(fa.numpy()), \
        _leaf(ts.signal.numpy())
    torch.sum(tf(fbl, fal, sig_all)[0] ** 2).backward()

    calls = []
    real = tbm._chunk_theta_grads

    def spy(*args):
        calls.append(1)
        return real(*args)

    sig = _leaf(ts.signal.numpy())
    try:
        tbm._chunk_theta_grads = spy
        loss = torch.sum(tf(fb, fa, sig)[0] ** 2)
        loss.backward(retain_graph=True)
    finally:
        tbm._chunk_theta_grads = real
    assert calls == []
    assert torch.equal(sig.grad, sig_all.grad) and torch.any(sig.grad != 0)
    with pytest.raises(RuntimeError, match="already freed"):
        loss.backward()


def test_forward_numbers_do_not_move_under_grad(meshes):
    """The grad-safe loop (fresh ``next``, injection on a copy) gives the
    bits of the three-buffer rotation, for both injection modes."""
    jm, tm = meshes
    steps = 12
    _, _, ts, tr = _point_problem(jm, tm, steps, "soft")
    for inject in (True, False):
        want = t_run.run_waveguide_box(tm.structure, tm.box_spec, ts, tr,
                                       steps, kernel_inject=inject)
        cb = tm.structure.coef_b.clone().requires_grad_(True)
        got = t_run.run_waveguide_box(
            dataclasses.replace(tm.structure, coef_b=cb), tm.box_spec, ts,
            tr, steps, kernel_inject=inject)
        assert got["outputs"].requires_grad
        assert not want["outputs"].requires_grad
        assert torch.equal(got["outputs"].detach(), want["outputs"])


# ---------------------------------------------------------------------------
# the checks of tests/test_gradients.py, on the port

def central_diff(f, x, eps):
    return (f(x + eps) - f(x - eps)) / (2 * eps)


def _grad_problem(jm, tm):
    desc = jm.descriptor
    src = desc.flat_index(jm.require_inside((0.6, 0.6, 0.4)))
    rcv = desc.flat_index(jm.require_inside((0.6, 0.6, 1.0)))
    return src, rcv


def _t_scale_loss(tm, src, rcv, steps, **kwargs):
    def loss(scale):
        s = dataclasses.replace(tm.structure,
                                coef_b=tm.structure.coef_b * scale)
        source = t_src.HardSource(
            node_idx=src, signal=t_src.impulse_signal(steps, 1.0, "cpu"))
        receiver = t_rcv.NodeReceiver(node_idx=torch.tensor(rcv))
        out = t_run.run_waveguide_box(s, tm.box_spec, source, receiver,
                                      steps, **kwargs)
        return torch.sum(torch.square(out["outputs"]))
    return loss


def _value_and_grad(loss, x0):
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    value = loss(x)
    value.backward()
    return float(value.detach()), x.grad.numpy()


def test_boundary_gradient_matches_jax_and_fd(grad_meshes):
    """d(IR energy)/d(scale of coef_b), 60 steps: the port's fused path
    against ``jax.grad`` of the reference's (rtol 1e-4) and against central
    differences (rtol 0.05)."""
    jm, tm = grad_meshes
    src, rcv = _grad_problem(jm, tm)
    steps = 60

    def jloss(scale):
        s = dataclasses.replace(jm.structure,
                                coef_b=jm.structure.coef_b * scale)
        source = j_src.HardSource(node_idx=jnp.asarray(src, jnp.int32),
                                  signal=j_src.impulse_signal(steps, 1.0))
        receiver = j_rcv.NodeReceiver(node_idx=jnp.asarray(rcv, jnp.int32))
        out = j_run.run_waveguide_box(s, jm.box_spec, source, receiver,
                                      steps)
        return jnp.sum(jnp.square(out["outputs"]))

    want = float(jax.grad(jloss)(1.0))
    loss = _t_scale_loss(tm, src, rcv, steps)
    _, g = _value_and_grad(loss, 1.0)
    np.testing.assert_allclose(float(g), want, rtol=1e-4)
    with torch.no_grad():
        fd = central_diff(lambda s: float(loss(torch.tensor(s))), 1.0, 1e-2)
    np.testing.assert_allclose(float(g), fd, rtol=0.05)


def test_checkpointed_run_same_value_and_grad(grad_meshes):
    """``checkpoint_every=16`` over 64 steps changes neither the value
    (rtol 1e-6) nor the gradient (rtol 1e-5)."""
    jm, tm = grad_meshes
    src, rcv = _grad_problem(jm, tm)
    v0, g0 = _value_and_grad(_t_scale_loss(tm, src, rcv, 64), 1.0)
    v1, g1 = _value_and_grad(
        _t_scale_loss(tm, src, rcv, 64, checkpoint_every=16), 1.0)
    assert g0 != 0
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    np.testing.assert_allclose(g1, g0, rtol=1e-5)


def test_source_position_gradient_matches_jax(grad_meshes):
    """d(IR energy)/d(source xyz) through the fused path with a
    ``PositionGaussianSource`` against ``jax.grad`` of the reference's
    (rtol 1e-3 of the largest component); values agree to rtol 1e-4."""
    jm, tm = grad_meshes
    _, rcv = _grad_problem(jm, tm)
    steps = 60
    sig = np.zeros(steps, np.float32)
    sig[:6] = np.hanning(6)
    centre = (0.55, 0.63, 0.42)
    jbase = j_src.make_position_source(jm.descriptor, centre, 2.5 * DX, sig,
                                       jm.inside)
    jrec = j_rcv.NodeReceiver(node_idx=jnp.asarray(rcv, jnp.int32))

    def jloss(pos):
        out = j_run.run_waveguide_box(
            jm.structure, jm.box_spec,
            dataclasses.replace(jbase, position=pos), jrec, steps)
        return jnp.sum(jnp.square(out["outputs"]))

    p0 = np.asarray(centre, np.float32)
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(p0))
    tbase = t_src.make_position_source(tm.descriptor, centre, 2.5 * DX, sig,
                                       tm.inside, device="cpu")
    assert np.array_equal(tbase.node_indices.numpy(),
                          np.asarray(jbase.node_indices))
    trec = t_rcv.NodeReceiver(node_idx=torch.tensor(rcv))
    pos = torch.tensor(p0, requires_grad=True)
    out = t_run.run_waveguide_box(
        tm.structure, tm.box_spec, dataclasses.replace(tbase, position=pos),
        trec, steps)
    value = torch.sum(torch.square(out["outputs"]))
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=1e-4)
    assert np.any(pos.grad.numpy() != 0)
    assert _rel(pos.grad.numpy(), jg) < 1e-3


def test_receiver_position_gradient_matches_jax(grad_meshes):
    """d(IR energy)/d(receiver xyz) through the trilinear
    ``InterpolatedReceiver`` against ``jax.grad`` of the reference's, rtol
    1e-3 of the largest component."""
    jm, tm = grad_meshes
    src, _ = _grad_problem(jm, tm)
    steps = 60
    where = (0.62, 0.57, 1.03)
    jsource = j_src.HardSource(node_idx=jnp.asarray(src, jnp.int32),
                               signal=j_src.impulse_signal(steps, 1.0))
    jbase = j_rcv.make_interpolated_receiver(jm.descriptor, where)

    def jloss(pos):
        out = j_run.run_waveguide_box(
            jm.structure, jm.box_spec, jsource,
            dataclasses.replace(jbase, position=pos), steps)
        return jnp.sum(jnp.square(out["outputs"]))

    p0 = np.asarray(where, np.float32)
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(p0))
    tsource = t_src.HardSource(
        node_idx=src, signal=t_src.impulse_signal(steps, 1.0, "cpu"))
    tbase = t_rcv.make_interpolated_receiver(tm.descriptor, where, "cpu")
    assert np.array_equal(tbase.corner_idx.numpy(),
                          np.asarray(jbase.corner_idx))
    pos = torch.tensor(p0, requires_grad=True)
    out = t_run.run_waveguide_box(
        tm.structure, tm.box_spec, tsource,
        dataclasses.replace(tbase, position=pos), steps)
    value = torch.sum(torch.square(out["outputs"]))
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=1e-4)
    assert np.any(pos.grad.numpy() != 0)
    assert _rel(pos.grad.numpy(), jg) < 1e-3


def test_gaussian_and_multinode_match_jax(grad_meshes):
    """``make_gaussian_source`` (clipped to inside nodes near a wall) and
    ``MultiNodeReceiver`` through the fused path against the reference,
    atol 2e-5 (``tests/test_box_fused.py``'s bound for that source)."""
    jm, tm = grad_meshes
    spec = tm.box_spec
    steps = 40
    sig = np.zeros(steps, np.float32)
    sig[:8] = np.hanning(8)
    near_wall = tuple(tm.descriptor.position(np.array(
        [spec.ilo[0] + 2, spec.ilo[1] + 5, spec.ilo[2] + 5])))
    nodes = [tm.descriptor.flat_index(tm.require_inside(p))
             for p in ((0.6, 0.6, 1.0), (0.3, 0.9, 0.7))]
    jsource = j_src.make_gaussian_source(jm.descriptor, near_wall, 3 * DX,
                                         sig, inside=jm.inside)
    tsource = t_src.make_gaussian_source(tm.descriptor, near_wall, 3 * DX,
                                         sig, inside=tm.inside, device="cpu")
    want = j_run.run_waveguide_box(
        jm.structure, jm.box_spec, jsource,
        j_rcv.MultiNodeReceiver(jnp.asarray(nodes, jnp.int32)), steps)
    got = t_run.run_waveguide_box(
        tm.structure, spec, tsource,
        t_rcv.MultiNodeReceiver(torch.tensor(nodes)), steps)
    assert tuple(got["outputs"].shape) == (steps, 2)
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), rtol=1e-5,
                               atol=2e-5)


BOX = ((0.0, 0.0, 0.0), (3.1, 2.6, 2.2))
IS_SRC, IS_RCV = (1.0, 1.2, 0.8), (2.2, 1.3, 1.5)


def test_image_source_absorption_gradient_matches_jax():
    """d(Σ volume²)/d(absorption) through the port's ``find_impulses``
    against ``jax.grad`` of the reference's (rtol 1e-4) and central
    differences (rtol 2e-3, ``tests/test_gradients.py``'s)."""
    def jloss(a):
        imp = j_exact.find_impulses(JBox(*BOX), IS_SRC, IS_RCV,
                                    jnp.full(8, a), 15.0)
        return jnp.sum(jnp.square(imp.volume))

    def tloss(a):
        imp = t_exact.find_impulses(TBox(*BOX), IS_SRC, IS_RCV,
                                    a * torch.ones(8), 15.0)
        return torch.sum(torch.square(imp.volume))

    _, g = _value_and_grad(tloss, 0.25)
    np.testing.assert_allclose(float(g), float(jax.grad(jloss)(0.25)),
                               rtol=1e-4)
    with torch.no_grad():
        fd = central_diff(lambda a: float(tloss(torch.tensor(a))), 0.25,
                          1e-3)
    np.testing.assert_allclose(float(g), fd, rtol=2e-3)


def test_image_source_position_gradient_matches_jax():
    """d(energy-weighted mean distance)/d(source x) through the port's
    ``find_impulses`` against ``jax.grad`` of the reference's (rtol 1e-3)
    and central differences (rtol 5e-3)."""
    def jloss(x):
        imp = j_exact.find_impulses(JBox(*BOX), jnp.asarray([x, 1.2, 0.8]),
                                    IS_RCV, jnp.full(8, 0.2), 12.0)
        w = jnp.square(imp.volume[:, 0])
        return jnp.sum(w * imp.distance) / jnp.sum(w)

    def tloss(x):
        src = torch.stack([x, torch.tensor(1.2), torch.tensor(0.8)])
        imp = t_exact.find_impulses(TBox(*BOX), src, IS_RCV,
                                    torch.full((8,), 0.2), 12.0)
        w = torch.square(imp.volume[:, 0])
        return torch.sum(w * imp.distance) / torch.sum(w)

    _, g = _value_and_grad(tloss, 1.0)
    np.testing.assert_allclose(float(g), float(jax.grad(jloss)(1.0)),
                               rtol=1e-3)
    # in float32 a step of 1e-4 leaves rounding noise of 10% in the
    # difference quotient; 1e-2 is still inside the smooth range
    with torch.no_grad():
        fd = central_diff(lambda x: float(tloss(torch.tensor(x))), 1.0, 1e-2)
    np.testing.assert_allclose(float(g), fd, rtol=5e-3)
