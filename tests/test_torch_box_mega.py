"""The port's mega chunk path against the JAX reference, on the CPU.

The port's plane step and its plain chunk (``_mega_chunk_plain``, the plain
version of the CUDA kernel) take the same inputs as the JAX functions.  The
whole-run cases hold ``run_waveguide_box_mega`` against JAX's mega path run
with ``interpret=True`` (chunk 4), at the bound ``tests/test_box_mega.py``
uses, atol 2e-5 on receiver outputs.  The six inner-plane sources are held
against JAX's fused path, which that suite holds equal to its mega path at
the same bound: one interpreted compile per source placement would cost
about 10 s each.  The CUDA kernel is held against the plain version on a
GPU, in ``tests/test_torch_kernels.py``.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core.geometry import Box as JBox, box_scene as jbox_scene
from wayverb_tpu.waveguide import box_mega as jbm
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide import receivers as j_rcv
from wayverb_tpu.waveguide import sources as j_src
from wayverb_tpu.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core.geometry import Box as TBox
from wayverb_tpu_torch.core.geometry import box_scene as t_box_scene
from wayverb_tpu_torch.utils import events
from wayverb_tpu_torch.waveguide import box_fused as tbf
from wayverb_tpu_torch.waveguide import box_mega as tbm
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import receivers as t_rcv
from wayverb_tpu_torch.waveguide import sources as t_src

torch.set_num_threads(2)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)
ATOL = 2e-5             # receiver-output bound of tests/test_box_mega.py
PLANE_ATOL = 1e-5       # plane-step bound of tests/test_box_mega.py
SRC, RCV = (0.7, 0.8, 0.5), (0.7, 0.8, 1.3)


@pytest.fixture(scope="module")
def meshes():
    """test_box_mega.py's small_mesh (aligned (8, 8, 128)) and the port's
    Mesh carried across from it."""
    box = JBox((0, 0, 0), (1.4, 1.6, 1.8))
    jm = j_run.compute_mesh(jbox_scene(box), np.full((1, 8), 0.12), DX, FS,
                            scene_box=box, align=(8, 8, 128))
    d, s = jm.descriptor, jm.box_spec
    tm = convert.mesh_from_numpy({
        "min_corner": np.asarray(d.min_corner),
        "dimensions": np.asarray(d.dimensions), "spacing": d.spacing,
        "inside": np.asarray(jm.inside),
        "coef_b": np.asarray(jm.structure.coef_b),
        "coef_a": np.asarray(jm.structure.coef_a),
        "room_volume": jm.room_volume,
        "box_dims": np.asarray(s.dims), "box_ilo": np.asarray(s.ilo),
        "box_ihi": np.asarray(s.ihi),
        "box_face_surface": np.asarray(s.face_surface)}, device="cpu")
    return jm, tm


def _jax_face_coefs(mesh):
    idx = np.asarray(mesh.box_spec.face_surface)
    return (jnp.asarray(mesh.structure.coef_b)[idx],
            jnp.asarray(mesh.structure.coef_a)[idx])


def test_plane_step_natural_matches(meshes, rng):
    """The port's plane step against JAX's ``plane_step_natural`` and
    against the port's stacked update, on random plane states; atol 1e-5."""
    jm, tm = meshes
    spec = tm.box_spec
    order = tm.structure.filter_order
    mk = lambda s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    pl6, in6, pr6 = ([mk(spec.plane_shape(p)) for p in range(6)]
                     for _ in range(3))
    st6 = [mk((order,) + spec.plane_shape(p)) for p in range(6)]
    t6 = lambda xs: tuple(map(torch.from_numpy, xs))  # noqa: E731
    fb, fa = tbf.face_coefficients(tm.structure, spec)
    got_p, got_st = tbm.plane_step_natural(spec, t6(pl6), t6(in6), t6(pr6),
                                           t6(st6), fb, fa)
    j6 = lambda xs: tuple(map(jnp.asarray, xs))  # noqa: E731
    want_p, want_st = jbm.plane_step_natural(jm.box_spec, j6(pl6), j6(in6),
                                             j6(pr6), j6(st6),
                                             *_jax_face_coefs(jm),
                                             kernel=False)
    stk_p, stk_st = tbf.plane_boundary_step_stacked(
        tbf.stack_planes(t6(pl6), spec), tbf.stack_planes(t6(in6), spec),
        tbf.stack_planes(t6(pr6), spec),
        tbf.stack_planes(tuple(torch.from_numpy(s).permute(1, 2, 0)
                               for s in st6), spec),
        spec, fb, fa)
    for p in range(6):
        U, V = spec.plane_shape(p)
        for want in (np.asarray(want_p[p]), stk_p[p, :U, :V].numpy()):
            np.testing.assert_allclose(got_p[p].numpy(), want, rtol=0,
                                       atol=PLANE_ATOL)
        for want in (np.asarray(want_st[p]),
                     stk_st[p, :U, :V].permute(2, 0, 1).numpy()):
            np.testing.assert_allclose(got_st[p].numpy(), want, rtol=0,
                                       atol=PLANE_ATOL)


def _problem(jm, tm, steps, src_loc, rcv_loc, source_kind, receiver_kind):
    """The same source and receiver for both packages."""
    desc = jm.descriptor
    node = desc.flat_index(src_loc)
    if source_kind == "hard":
        amp = t_src.rectilinear_calibration_factor(desc.spacing, 400.0)
    else:
        amp = 1.5
    jcls, tcls = ((j_src.HardSource, t_src.HardSource) if source_kind == "hard"
                  else (j_src.SoftSource, t_src.SoftSource))
    jsource = jcls(node_idx=jnp.asarray(node, dtype=jnp.int32),
                   signal=j_src.impulse_signal(steps, amp))
    tsource = tcls(node_idx=node,
                   signal=t_src.impulse_signal(steps, amp, "cpu"))
    rnode = desc.flat_index(rcv_loc)
    if receiver_kind == "node":
        return (jsource, j_rcv.NodeReceiver(jnp.asarray(rnode, jnp.int32)),
                tsource, t_rcv.NodeReceiver(torch.tensor(rnode)))
    fs = desc.sample_rate(340.0)
    pos = desc.position(rcv_loc)
    return (jsource, j_rcv.make_directional_receiver(desc, fs, 1.225, pos),
            tsource, t_rcv.make_directional_receiver(tm.descriptor, fs, 1.225,
                                                     pos, "cpu"))


def _assert_outputs_close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("steps,source_kind,receiver_kind", [
    (16, "hard", "directional"),    # test_whole_run_matches_fused
    (11, "soft", "node"),           # padded tail: 11 is not a chunk multiple
])
def test_run_waveguide_box_mega_matches_jax(meshes, steps, source_kind,
                                            receiver_kind):
    jm, tm = meshes
    src_loc = jm.require_inside(SRC)
    rcv_loc = jm.require_inside(RCV)
    js, jr, ts, tr = _problem(jm, tm, steps, src_loc, rcv_loc, source_kind,
                              receiver_kind)
    want = jbm.run_waveguide_box_mega(jm.structure, jm.box_spec, js, jr,
                                      steps, chunk=4, interpret=True)
    got = tbm.run_waveguide_box_mega(tm.structure, tm.box_spec, ts, tr,
                                     steps, chunk=4)
    _assert_outputs_close(got["outputs"], want["outputs"])
    assert bool(got["stable"]) and bool(want["stable"])


def _spans(fn):
    """{name: count} of the ``wayverb.*`` spans ``fn()`` records under a CPU
    profiler, and [(name, start, end)] of them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(events.SPAN_PREFIX)]
    return Counter(n for n, _, _ in spans), spans


def test_spans_of_the_mega_run_and_its_gradient(meshes):
    """One forward and one backward span a run, one chunk_bwd and one
    theta_grads span a chunk inside the backward's; one replay span a
    render."""
    jm, tm = meshes
    steps, chunk = 12, 4
    _, _, ts, tr = _problem(jm, tm, steps, jm.require_inside(SRC),
                            jm.require_inside(RCV), "hard", "directional")
    f = tbm.mega_canonical_loss_fn(tm.structure, tm.box_spec, ts, tr, steps,
                                   chunk=chunk)
    fb, fa = (t.detach().requires_grad_(True)
              for t in tbf.face_coefficients(tm.structure, tm.box_spec))
    sig = ts.signal.clone().requires_grad_(True)

    def gradient():
        taps, _ = f(fb, fa, sig)
        torch.sum(taps ** 2).backward()

    counts, spans = _spans(gradient)
    nchunks = steps // chunk
    assert counts == {"wayverb.mega.forward": 1, "wayverb.mega.backward": 1,
                      "wayverb.mega.chunk_bwd": nchunks,
                      "wayverb.mega.theta_grads": nchunks}
    (_, b0, b1), = [s for s in spans if s[0] == "wayverb.mega.backward"]
    assert all(b0 <= s0 <= s1 <= b1 for n, s0, s1 in spans
               if n in ("wayverb.mega.chunk_bwd", "wayverb.mega.theta_grads"))
    assert fb.grad is not None and sig.grad is not None

    counts, _ = _spans(lambda: tbm.run_waveguide_box_mega(
        tm.structure, tm.box_spec, ts, tr, steps, chunk=chunk))
    assert counts == {"wayverb.mega.forward": 1,
                      "wayverb.mega.replay_taps": 1}


def test_compute_mesh_timings_and_spans():
    """``compute_mesh(timings=)`` of a box: the three stages, the
    classifier and the box's regions, each stage also a span."""
    events.reset_totals()
    box = TBox((0, 0, 0), (1.4, 1.6, 1.8))
    timings = {}
    mesh = t_run.compute_mesh(t_box_scene(box), np.full((1, 8), 0.12), DX,
                              FS, scene_box=box, device="cpu",
                              timings=timings)
    assert mesh.box_spec is not None
    assert set(timings) == {"classify_s", "fit_s", "structure_s",
                            "classifier", "regions_s"}
    assert timings["classifier"] == "shoebox"
    totals = events.totals()
    for stage in ("classify", "fit", "structure", "regions"):
        seconds, entries = totals[f"setup.{stage}"]
        assert entries == 1 and seconds == timings[f"{stage}_s"] >= 0.0
    events.reset_totals()


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("side", [0, 1])
def test_source_on_inner_plane(meshes, axis, side):
    """A soft source on each inner boundary plane, mirrored into the carried
    planes (``_patch_ins``), against JAX's fused path; atol 2e-5."""
    jm, tm = meshes
    spec = tm.box_spec
    steps = 10
    loc = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    loc[axis] = spec.ilo[axis] if side == 0 else spec.ihi[axis]
    rcv = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    rcv[2] += 2
    js, jr, ts, tr = _problem(jm, tm, steps, tuple(loc), tuple(rcv), "soft",
                              "node")
    assert tbm._inner_plane_source(spec, ts.kernel_injection(
        spec.dims, 0)[0])[0][0] == 2 * axis + side
    # jitted, so the six placements share one compile (the node index is
    # traced)
    want = j_run._run_waveguide_box_jit(jm.structure, jm.box_spec, js, jr,
                                        steps)
    got = tbm.run_waveguide_box_mega(tm.structure, spec, ts, tr, steps,
                                     chunk=4)
    _assert_outputs_close(got["outputs"], want["outputs"])


@pytest.mark.parametrize("where,sides", [
    ("edge", (0, 1, None)),       # on the inner x-lo and y-hi planes
    ("corner", (1, 0, 1)),        # on the inner x-hi, y-lo and z-hi planes
])
def test_source_on_inner_edge_and_corner(meshes, where, sides):
    """A soft source on an edge (two inner planes patched at once) and on a
    corner (three) of the inner box, against JAX's fused path; atol 2e-5,
    as ``test_source_on_inner_plane``."""
    jm, tm = meshes
    spec = tm.box_spec
    steps = 10
    loc = [(spec.ilo[a] + spec.ihi[a]) // 2 if side is None
           else (spec.ilo[a] if side == 0 else spec.ihi[a])
           for a, side in enumerate(sides)]
    rcv = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    rcv[2] += 2
    js, jr, ts, tr = _problem(jm, tm, steps, tuple(loc), tuple(rcv), "soft",
                              "node")
    planes = [pi for pi, _, _ in tbm._inner_plane_source(
        spec, ts.kernel_injection(spec.dims, 0)[0])]
    assert planes == [2 * a + side for a, side in enumerate(sides)
                      if side is not None]
    want = j_run._run_waveguide_box_jit(jm.structure, jm.box_spec, js, jr,
                                        steps)
    got = tbm.run_waveguide_box_mega(tm.structure, spec, ts, tr, steps,
                                     chunk=4)
    _assert_outputs_close(got["outputs"], want["outputs"])


def test_chunks_chain(meshes):
    """Two chunks of 4 equal one chunk of 8, state and taps alike (the
    plain chunk returns (cur, prev) in the reference's order)."""
    _, tm = meshes
    spec = tm.box_spec
    order = tm.structure.filter_order
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    gen = torch.Generator().manual_seed(3)
    sig = torch.randn(8, generator=gen)
    fb, fa = tbf.face_coefficients(tm.structure, spec)
    src = (spec.ilo[0] + 2, spec.ilo[1] + 3, spec.ilo[2] + 1, 2)
    taps = torch.tensor([0, 5, spec.dims[2] * spec.dims[1] * 3 + 77])
    init = (torch.zeros(spec.dims), torch.zeros(spec.dims),
            torch.zeros((order, 6, Umax, Vmax)),
            torch.zeros((3, 6, Umax, Vmax)))
    whole = tbm.mega_chunk(spec, sig, fb, fa, *init, src, taps)
    half = tbm.mega_chunk(spec, sig[:4], fb, fa, *init, src, taps)
    half2 = tbm.mega_chunk(spec, sig[4:], fb, fa, *half[:4], src, taps)
    for a, b in zip(whole[:4], half2[:4]):
        assert torch.equal(a, b)
    assert torch.equal(whole[4], torch.cat([half[4], half2[4]]))
    assert float(whole[5]) == 0.0


def test_replay_matches_direct_tap(meshes, rng):
    """``replay_taps`` over a (T, k) block equals the receiver tapping the
    whole field step by step; rtol 1e-6."""
    _, tm = meshes
    desc = tm.descriptor
    rcv_loc = tm.require_inside(RCV)
    receiver = t_rcv.make_directional_receiver(
        desc, desc.sample_rate(340.0), 1.225, desc.position(rcv_loc), "cpu")
    nodes = receiver.tap_nodes()
    fields = torch.from_numpy(
        rng.normal(size=(5, desc.num_nodes)).astype(np.float32))
    intensity, pressure = tbm.replay_taps(receiver, fields[:, nodes])
    state = receiver.init_state(torch.float32, "cpu")
    for t in range(5):
        state, (i_t, p_t) = receiver.tap(fields[t], state)
        np.testing.assert_allclose(intensity[t].numpy(), i_t.numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(pressure[t].numpy(), p_t.numpy(),
                                   rtol=1e-6)


def test_cpu_never_takes_the_mega_path(meshes, monkeypatch):
    """``mega_supported`` is False off CUDA, and ``execute`` on CPU tensors
    takes the fused path: the mega runner and the plain chunk are replaced
    by functions that raise, so reaching either fails the test."""
    jm, tm = meshes
    js, jr, ts, tr = _problem(jm, tm, 8, jm.require_inside(SRC),
                              jm.require_inside(RCV), "hard", "node")
    assert not tbm.mega_supported(tm.box_spec, ts, tr, "cpu")
    assert not tbm.mega_supported(None, ts, tr, "cpu")

    def mega_reached(*args, **kwargs):
        raise AssertionError("execute took the mega path on the CPU")

    monkeypatch.setattr(t_run, "run_waveguide_box_mega", mega_reached)
    monkeypatch.setattr(tbm, "_mega_chunk_plain", mega_reached)
    launches = tbf.fused_step.launches, tbm.mega_chunk.launches
    out = t_run.execute(tm, ts, tr, 8)
    want = t_run.run_waveguide_box(tm.structure, tm.box_spec, ts, tr, 8)
    assert torch.equal(out["outputs"], want["outputs"])
    assert (tbf.fused_step.launches, tbm.mega_chunk.launches) == launches
    with pytest.raises(ValueError, match="device"):
        tbm.mega_chunk(tm.box_spec, torch.zeros(4, device="meta"), None,
                       None, torch.zeros(tm.box_spec.dims, device="meta"),
                       None, None, None, (0, 0, 0, 0), None)


@pytest.mark.parametrize("kernel_inject", [True, False])
def test_execute_matches_jax(meshes, monkeypatch, kernel_inject):
    """``execute`` on CPU tensors with the source injected inside the fused
    step (``kernel_inject=True``) or into the field before each step
    (``False``), against JAX's ``execute`` with the same argument; atol
    2e-5.  The argument reaches the fused runner unchanged."""
    jm, tm = meshes
    steps = 16
    js, jr, ts, tr = _problem(jm, tm, steps, jm.require_inside(SRC),
                              jm.require_inside(RCV), "hard", "directional")
    seen = []
    fused = t_run.run_waveguide_box

    def spy(*args, **kwargs):
        seen.append(kwargs["kernel_inject"])
        return fused(*args, **kwargs)

    monkeypatch.setattr(t_run, "run_waveguide_box", spy)
    got = t_run.execute(tm, ts, tr, steps, kernel_inject=kernel_inject)
    want = j_run.execute(jm, js, jr, steps, kernel_inject=kernel_inject)
    assert seen == [kernel_inject]
    _assert_outputs_close(got["outputs"], want["outputs"])
    assert bool(got["stable"]) and bool(want["stable"])


# ---------------------------------------------------------------------------
# the adjoint chunk in the CUDA kernel's two-field form (csrc/
# box_mega_chunk_bwd.cu), in plain torch, against _mega_chunk_bwd_plain

BWD_REL = 1e-5          # B7 against its plain version, of the largest value
BWD_BOX = tbf.BoxSpec(dims=(21, 17, 26), ilo=(2, 3, 2), ihi=(18, 13, 23),
                      face_surface=(0,) * 6)


def _bwd_case(mode, where, K, seed=11):
    """Cotangents on the unaligned 21 x 17 x 26 box of the card tests (zero
    in the planes' padding), per-face filters of order 6, and the source in
    the middle, on the inner z-lo plane or on the inner x-lo/y-hi edge, with
    taps at the source (twice), beside it and at a far node."""
    spec = BWD_BOX
    X, Y, Z = spec.dims
    order = 6
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    rng = np.random.default_rng(seed)
    mask = np.zeros((6, Umax, Vmax), np.float32)
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    src = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    if where == "plane":
        src[2] = spec.ilo[2]
    elif where == "edge":
        src[0], src[1] = spec.ilo[0], spec.ihi[1]
    flat = (src[0] * Y + src[1]) * Z + src[2]
    taps = torch.tensor([flat, flat + 1, flat, (1 * Y + 5) * Z + 7])
    fb = np.array([[1.0, 0.1, 0.05, 0.02, 0.0, 0.01, 0.0]] * 6) * 2.0 \
        + 0.01 * np.arange(6)[:, None]
    fa = np.array([[1.0, -0.2, 0.01, 0.0, 0.03, 0.0, 0.0]] * 6)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    cot = (mk(K, taps.numel()), mk(*spec.dims), mk(*spec.dims),
           mk(order, 6, Umax, Vmax) * torch.from_numpy(mask))
    return (spec, torch.tensor(fb, dtype=torch.float32),
            torch.tensor(fa, dtype=torch.float32), *cot,
            tuple(src) + (mode,), taps)


def _plane_slices(field, spec):
    """ĝpplus: the field at the six plane coordinates under the splice
    precedence y < z < x (an x plane beats a z plane beats a y plane)."""
    blo = [tbm._plane_coord(spec, 2 * a) for a in range(3)]
    bhi = [tbm._plane_coord(spec, 2 * a + 1) for a in range(3)]
    out = []
    for pi, (a, _) in enumerate(tbf.PLANES):
        sl = field.select(a, tbm._plane_coord(spec, pi)).clone()
        if a > 0:
            sl[blo[0]] = 0.0
            sl[bhi[0]] = 0.0
        if a == 1:
            sl[:, blo[2]] = 0.0
            sl[:, bhi[2]] = 0.0
        out.append(sl)
    return out


def _autograd_transpose(spec, fb, fa, order):
    """(gp6, gst) → (ĝpl6, ĝin6, ĝprev6, ĝst): the plane updates' transpose
    as the plain version takes it, autograd of plane_step_natural at zero
    primals."""
    shp = [spec.plane_shape(p) for p in range(6)]
    with torch.enable_grad():
        zeros = lambda *lead: tuple(  # noqa: E731
            torch.zeros(lead + s, requires_grad=True) for s in shp)
        pl6, in6, prev6, st6 = zeros(), zeros(), zeros(), zeros(order)
        pplus, newst = tbm.plane_step_natural(spec, pl6, in6, prev6, st6, fb,
                                              fa)
    primals = (*pl6, *in6, *prev6, *st6)

    def transpose(gp6, gst):
        gst6 = tuple(gst[:, p, :U, :V] for p, (U, V) in enumerate(shp))
        grads = torch.autograd.grad((*pplus, *newst), primals,
                                    (*gp6, *gst6), retain_graph=True)
        gpl6, gin6, gprev6, gst6 = (grads[6 * i:6 * i + 6] for i in range(4))
        gst = tbf.stack_planes(tuple(s.permute(1, 2, 0) for s in gst6),
                               spec).permute(3, 0, 1, 2).contiguous()
        return gpl6, gin6, gprev6, gst
    return transpose


def _kernel_transpose(spec, fb, fa, order):
    """The same transpose as the kernel writes it out by hand, element by
    element (see csrc/box_mega_chunk_bwd.cu): D, ĝprev and ĝst's local part
    from the element's own values, then ĝpl gathered from D of the four
    in-plane neighbours, ĝin = 2 λ² D, and the edge coupling of the planes
    through each node into ĝst's slot 0."""
    c, c2 = float(np.float32(tbm.COURANT)), tbm.COURANT_SQ
    blo = [tbm._plane_coord(spec, 2 * a) for a in range(3)]
    bhi = [tbm._plane_coord(spec, 2 * a + 1) for a in range(3)]
    ratio = fa[:, 0] / fb[:, 0]

    def weights(i, lo, hi, at_lo, at_hi):
        return torch.where(i == lo, at_lo, torch.where(i == hi, at_hi, 1.0))

    def transpose(gp6, gst):
        D6, gprev6, gst_new = [], [], torch.zeros_like(gst)
        for p, (ax, _) in enumerate(tbf.PLANES):
            a1, a2 = tbf._other_axes(ax)
            U, V = spec.plane_shape(p)
            u = torch.arange(U).view(U, 1)
            v = torch.arange(V).view(1, V)
            gs = gst[:, p, :U, :V]
            b0, a0 = fb[p, 0], fa[p, 0]
            sum_a = sum_b = torch.zeros(U, V)
            for j in range(order - 1, -1, -1):
                sum_a = sum_a + fa[p, j + 1] * gs[j]
                sum_b = sum_b + fb[p, j + 1] * gs[j]
            gout = -sum_a
            gfilt = sum_b + gout * b0 / a0
            gdelta = -(gfilt * a0) / (b0 * c)
            cw = ratio[p].expand(U, V)
            for i, e in ((u, a1), (v, a2)):
                cw = torch.where(i == blo[e], cw + ratio[2 * e], cw)
                cw = torch.where(i == bhi[e], cw + ratio[2 * e + 1], cw)
            cw = c * cw
            act = ((u >= blo[a1]) & (u <= bhi[a1]) & (v >= blo[a2])
                   & (v <= bhi[a2])).float()
            D = act * ((gp6[p] - gdelta) / (1.0 + cw))
            D6.append(D)
            gprev6.append(gdelta + (cw - 1.0) * D)
            gst_new[0, p, :U, :V] = gout / a0 - gfilt / b0
            gst_new[1:, p, :U, :V] = gs[:-1]
        gpl6, gin6 = [], []
        for p, (ax, _) in enumerate(tbf.PLANES):
            a1, a2 = tbf._other_axes(ax)
            U, V = spec.plane_shape(p)
            u = torch.arange(U).view(U, 1)
            v = torch.arange(V).view(1, V)
            cD = D6[p] * c2
            wm = lambda i, e: weights(i, blo[e], bhi[e], 0.0, 2.0)  # noqa
            wp = lambda i, e: weights(i, blo[e], bhi[e], 2.0, 0.0)  # noqa
            gpl = torch.zeros(U, V)
            gpl[:-1] += wm(u + 1, a1)[:-1] * cD[1:]
            gpl[1:] += wp(u - 1, a1)[1:] * cD[:-1]
            gpl[:, :-1] += wm(v + 1, a2)[:, :-1] * cD[:, 1:]
            gpl[:, 1:] += wp(v - 1, a2)[:, 1:] * cD[:, :-1]
            gpl6.append(gpl)
            gin6.append(2.0 * cD)
        # the coupling: D of every other plane through the element's node
        grids = []
        for q, (ax, _) in enumerate(tbf.PLANES):
            g = torch.zeros(spec.dims)
            g.select(ax, tbm._plane_coord(spec, q)).copy_(D6[q])
            grids.append(g)
        for p, (ax, _) in enumerate(tbf.PLANES):
            U, V = spec.plane_shape(p)
            d = D6[p]
            for q in range(6):
                if tbf.PLANES[q][0] != ax:
                    d = d + grids[q].select(ax, tbm._plane_coord(spec, p))
            gst_new[0, p, :U, :V] += c2 * d / fb[p, 0]
        return gpl6, gin6, gprev6, gst_new
    return transpose


def _two_field_bwd(spec, fb, fa, gtaps, gnext, gcur, gst, src, tap_idx,
                   transpose):
    """The adjoint chunk on two fields in place, as the kernel runs it.

    Sub-step t reads P̂_t from field (K − 1 − t) % 2 and overwrites the
    other field, which holds the previous sub-step's P̂, with
    R = (−M ⊙ P̂_{t+1} + ĝprev_{t+1} at the plane coordinates), or the
    explicit ĝcur at t = K − 1, + λ² Σ₆ M ⊙ P̂_t, then for each plane in
    order ĝpl at its coordinate and ĝin at its inner coordinate, the taps
    one by one in tap order, ĝsig_t = R[src] and a hard source's zero.
    ĝprev alternates between two buffers by t; Q̂ is written out (into the
    spare) only after the last sub-step."""
    K = gtaps.shape[0]
    X, Y, Z = spec.dims
    sx, sy, sz, mode = src
    src_flat = (sx * Y + sy) * Z + sz if mode > 0 else -1
    ar = lambda n, shape: torch.arange(n).view(shape)  # noqa: E731
    inside = tbf._inside_mask(ar(X, (X, 1, 1)), ar(Y, (1, Y, 1)),
                              ar(Z, (1, 1, Z)), spec.geom_array())
    step = transpose(spec, fb, fa, gst.shape[0])

    def implicit_q(older, gprev6):
        q = -torch.where(inside, older, torch.zeros(()))
        for pi, (a, _) in enumerate(tbf.PLANES):
            q.select(a, tbm._plane_coord(spec, pi)).add_(gprev6[pi])
        return q

    fields = [gnext.clone(), gcur.clone()]
    gst = gst.clone()
    gprv = [None, None]
    gsig = torch.zeros(K)
    gp_stream, gstin_stream = [None] * K, [None] * K
    for t in range(K - 1, -1, -1):
        A, B = fields[(K - 1 - t) % 2], fields[(K - t) % 2]
        # plane pass
        gp6 = _plane_slices(A, spec)
        gp_stream[t] = tbf.stack_planes(gp6, spec)
        gstin_stream[t] = gst
        gpl6, gin6, gprv[t % 2], gst = step(gp6, gst)
        # node pass, over the older field
        R = B.clone() if t == K - 1 else implicit_q(B, gprv[(t + 1) % 2])
        R = R + tbm.COURANT_SQ * tbf._neighbor_sum(
            torch.where(inside, A, torch.zeros(())))
        for pi, (a, _) in enumerate(tbf.PLANES):
            R.select(a, tbm._plane_coord(spec, pi)).add_(gpl6[pi])
            R.select(a, tbm._plane_coord(spec, pi, inner=True)).add_(
                gin6[pi])
        flat = R.view(-1)
        for j in range(tap_idx.numel()):
            flat[tap_idx[j]] += gtaps[t, j]
        if src_flat >= 0:
            gsig[t] = flat[src_flat]
            if mode == 1:
                flat[src_flat] = 0.0
        B.copy_(R)
    spare = implicit_q(fields[(K - 1) % 2], gprv[0])
    return (fields[K % 2], spare, gst, gsig, torch.stack(gp_stream),
            torch.stack(gstin_stream))


@pytest.mark.parametrize("transpose", ["autograd", "kernel"])
@pytest.mark.parametrize("K", [2, 4, 6, 8])
@pytest.mark.parametrize("where", ["middle", "plane", "edge"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_two_field_adjoint_matches_plain(mode, where, K, transpose):
    """The adjoint chunk in the kernel's two-field in-place form against
    ``_mega_chunk_bwd_plain`` on the card tests' unaligned box, with a
    duplicated tap at the source.  With the plain version's own transpose
    of the plane updates (autograd) every sum runs in the same order, so
    all six outputs are equal to the bit (0.0); with the kernel's
    hand-written transpose each is within 1e-5 of its largest value."""
    spec, fb, fa, *cot, src, taps = _bwd_case(mode, where, K)
    want = tbm._mega_chunk_bwd_plain(spec, fb, fa, *cot, src, taps)
    got = _two_field_bwd(spec, fb, fa, *cot, src, taps,
                         _autograd_transpose if transpose == "autograd"
                         else _kernel_transpose)
    names = ("gnext", "gcur", "gst", "gsig", "gp_stream", "gstin_stream")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if transpose == "autograd":
            assert torch.equal(g, w), name
        else:
            err = float((g - w).abs().max())
            assert err <= BWD_REL * float(w.abs().max()), (name, err)
    if mode == 0:
        assert float(got[3].abs().max()) == 0.0
    else:
        assert float(want[3].abs().max()) > 0.0
