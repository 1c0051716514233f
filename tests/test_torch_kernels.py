"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU mode)
and skips without CUDA.  The file imports neither JAX nor the reference
package, so it runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from wayverb_tpu_torch.core.geometry import Box
from wayverb_tpu_torch.waveguide import box_fused as tbf
from wayverb_tpu_torch.waveguide import box_mega as tbm
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

# the scenes of B4's cluster split and of B3's split, shared with their CPU
# tests
from test_torch_mt_cluster import SCENES, _scene  # noqa: E402
from test_torch_mt_split import B3_SCENES, _b3_scene  # noqa: E402

ATOL = 1e-5          # the bound tests/test_box_fused.py holds Pallas to
MEGA_REL = 1e-5      # B2 against its plain version, per unit of peak
BWD_REL = 1e-5       # B6's residuals and B7 against plain, of the largest
GRAD_REL = 1e-4      # whole-path gradients, of the largest component


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


HALL = (224, 224, 256)


# (grid dims, x offset, rows, source (global x, y, z), mode, input scale):
# a shard is `rows` x rows from global row `x offset`, with halo rows.  The
# kernel's CTAs are 128 z x 2 y of one x row, its warps 32 z: the tile
# edges below are those of its CTAs and warps
FUSED_CASES = [
    ((16, 16, 128), 0, 16, (8, 9, 64), 0, 1.0),
    ((16, 16, 128), 0, 16, (8, 9, 64), 1, 1.0),
    ((16, 16, 128), 0, 16, (2, 4, 64), 2, 1.0),
    ((37, 29, 53), 0, 37, (18, 14, 26), 2, 1.0),
    # a source on each side of a y tile edge and of a z (warp) tile edge
    ((37, 29, 53), 0, 37, (18, 15, 26), 1, 1.0),
    ((37, 29, 53), 0, 37, (18, 16, 26), 2, 1.0),
    ((37, 29, 53), 0, 37, (18, 14, 31), 1, 1.0),
    ((37, 29, 53), 0, 37, (18, 14, 32), 2, 1.0),
    # a source in the halo-adjacent rows of a shard inside the box
    ((37, 29, 53), 8, 16, (8, 14, 26), 1, 1.0),
    ((37, 29, 53), 8, 16, (23, 14, 26), 2, 1.0),
    # two rows
    ((37, 29, 53), 20, 2, (21, 14, 26), 1, 1.0),
    # the sharded hall's shard shape, a source at the centre, then on each
    # side of a CTA edge in z (128) and in y, in two adjacent x rows
    (HALL, 56, 56, (84, 112, 128), 1, 1.0),
    (HALL, 56, 56, (83, 113, 127), 2, 1.0),
    (HALL, 56, 56, (84, 114, 128), 1, 1.0),
    # sums that overflow: the infinities and NaNs agree
    ((37, 29, 53), 0, 37, (18, 14, 26), 2, 1e38),
    ((16, 16, 128), 0, 16, (8, 9, 31), 1, 1e38),
]


def _fused_case(device, dims, x_off, rows, src, mode, scale, seed=0):
    """(spec, args of fused_step) on random inputs, halo rows included: the
    box inside [2, dim - 3] on every axis."""
    inside = np.zeros(dims, dtype=bool)
    inside[2:-2, 2:-2, 2:-2] = True
    spec = tbf.spec_from_inside(inside)
    _, Y, Z = dims
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device=device) * scale
    cur, prev = rnd(rows, Y, Z), rnd(rows, Y, Z)
    planes = tuple(rnd(*s) for s in tbf._plane_shapes(rows, Y, Z))
    halos = (rnd(1, Y, Z), rnd(1, Y, Z))
    return spec, (spec.geom_array(x_offset=x_off), cur, prev, planes,
                  src + (mode,), rnd(2), halos)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,x_off,rows,src,mode,scale", FUSED_CASES)
def test_fused_step_kernel_matches_plain(cuda_device, dims, x_off, rows, src,
                                         mode, scale):
    """B1 against ``_fused_step_plain`` to the bit (NaN where the plain
    version has NaN), in ``next`` and the six inner planes; one launch."""
    _, args = _fused_case(cuda_device, dims, x_off, rows, src, mode, scale)
    before = tbf.fused_step.launches
    got_next, got_inner = tbf.fused_step(*args)
    assert tbf.fused_step.launches == before + 1
    want_next, want_inner = tbf._fused_step_plain(*args)
    torch.cuda.synchronize()
    assert _nan_equal(got_next, want_next)
    for q, (g, w) in enumerate(zip(got_inner, want_inner)):
        assert _nan_equal(g, w), q
    if scale > 1.0:
        assert not bool(torch.isfinite(want_next).all())


@pytest.mark.cuda
def test_fused_step_occupancy(cuda_device):
    """What the card makes of B1: no local memory, at least one CTA an SM,
    and at the hall one thread a node (CTAs x threads cover the field)."""
    occ = tbf.step_occupancy(cuda_device, HALL)
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 255, occ
    assert occ["ctas_per_sm"] >= 1, occ
    assert occ["grid"] * occ["threads"] >= HALL[0] * HALL[1] * HALL[2], occ


@pytest.mark.cuda
def test_fused_step_kernel_rejects_what_it_cannot_take(cuda_device):
    _, (geom, cur, prev, planes, _, _, _) = _fused_case(
        cuda_device, (16, 16, 128), 0, 16, (0, 0, 0), 0, 1.0)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur.double(), prev.double(), planes)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur.transpose(1, 2).contiguous().transpose(1, 2),
                       prev, planes)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur, prev, planes, out=cur)
    with pytest.raises(ValueError, match="overlap"):
        tbf.fused_step(geom, cur, prev, planes, out=prev)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur, prev, planes[:5] + (planes[5].t(),))


@pytest.mark.cuda
def test_canonical_on_the_card_matches_cpu(cuda_device):
    """The waveguide leg on the card against the plain CPU run of the same
    case, bound 1e-5 per unit of peak.  On the card ``canonical`` takes the
    mega path, ⌈300/128⌉ = 3 chunk launches and no fused step; on the CPU
    the fused path's plain version, no launch."""
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
    outs = []
    for device in (cuda_device, "cpu"):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                                  device=device)
        before = tbf.fused_step.launches, tbm.mega_chunk.launches
        outs.append(wgrun.canonical(mesh, (0.7, 0.8, 0.6), (0.7, 0.8, 1.3),
                                    0.09))
        launched = (tbf.fused_step.launches - before[0],
                    tbm.mega_chunk.launches - before[1])
        assert launched == ((0, 3) if device == cuda_device else (0, 0))
    card, cpu = outs
    assert bool(card.stable) and bool(cpu.stable)
    peak = float(cpu.pressure.abs().max())
    assert float((card.pressure.cpu() - cpu.pressure).abs().max()) <= \
        ATOL * max(1.0, peak)
    assert float((card.intensity.cpu() - cpu.intensity).abs().max()) <= ATOL


@pytest.mark.cuda
def test_canonical_multiband_on_the_card(cuda_device):
    """Two bands on the card: each band takes the mega path, ⌈300/128⌉ = 3
    chunk launches a band and no fused step, and equals ``canonical`` on
    the mesh with that band's flat tables to the bit."""
    from wayverb_tpu_torch.waveguide import boundary as bdry
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    absorption = np.tile(np.linspace(0.3, 0.05, 8), (1, 1))
    mesh = wgrun.shoebox_mesh(Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8)),
                              absorption, dx, fs, device=cuda_device)
    src, rcv = (0.7, 0.8, 0.6), (0.7, 0.8, 1.3)
    before = tbf.fused_step.launches, tbm.mega_chunk.launches
    bands = wgrun.canonical_multiband(mesh, absorption, src, rcv, 0.09, 2)
    assert (tbf.fused_step.launches - before[0],
            tbm.mega_chunk.launches - before[1]) == (0, 2 * 3)
    for b, band in enumerate(bands):
        assert bool(band.stable) and band.pressure.shape == (300,)
        cb, ca = bdry.coefficient_table(
            [bdry.to_flat_coefficients(float(absorption[0, b]))])
        structure = dataclasses.replace(
            mesh.structure, coef_b=torch.as_tensor(cb, device=cuda_device),
            coef_a=torch.as_tensor(ca, device=cuda_device))
        one = wgrun.canonical(dataclasses.replace(mesh, structure=structure),
                              src, rcv, 0.09)
        assert torch.equal(band.pressure, one.pressure)
        assert torch.equal(band.intensity, one.intensity)


@pytest.mark.cuda
def test_hrtf_attenuation_on_the_card_equals_cpu(cuda_device):
    """``Hrtf.attenuation`` reads the same table entries on the card as on
    the CPU, to the bit, for both ears of a rotated head; the ear
    positions too."""
    from wayverb_tpu_torch.core.attenuator import Hrtf
    from wayverb_tpu_torch.core.orientation import Orientation
    gen = torch.Generator().manual_seed(17)
    v = torch.randn(65536, 3, generator=gen) \
        * torch.rand(65536, 1, generator=gen) * 10
    v[0] = 0.0
    for channel in (0, 1):
        for orientation in (Orientation(),
                            Orientation((0.3, 0.2, 0.9), (0.1, 1.0, 0.0))):
            h = Hrtf(orientation, channel)
            card = h.attenuation(v.to(cuda_device))
            assert card.device.type == "cuda"
            assert torch.equal(card.cpu(), h.attenuation(v))
            base = torch.tensor([2.09, 3.08, 0.96])
            assert torch.equal(h.ear_position(base.to(cuda_device)).cpu(),
                               h.ear_position(base))


@pytest.mark.cuda
def test_fused_path_on_the_card_matches_cpu(cuda_device):
    """``run_waveguide_box`` (the fused path, one B1 launch per step) on
    the card against the same run on the CPU; bound 1e-5 per unit of
    peak."""
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
    outs = []
    for device in (cuda_device, "cpu"):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                                  device=device)
        source, receiver, n, _ = wgrun.canonical_problem(
            mesh, (0.7, 0.8, 0.6), (0.7, 0.8, 1.3), 0.09)
        before = tbf.fused_step.launches
        outs.append(wgrun.run_waveguide_box(mesh.structure, mesh.box_spec,
                                            source, receiver, n))
        assert tbf.fused_step.launches - before == \
            (n if device == cuda_device else 0)
    (card_i, card_p), (cpu_i, cpu_p) = (o["outputs"] for o in outs)
    peak = float(cpu_p.abs().max())
    assert float((card_p.cpu() - cpu_p).abs().max()) <= ATOL * max(1.0, peak)
    assert float((card_i.cpu() - cpu_i).abs().max()) <= ATOL


@pytest.mark.cuda
def test_execute_kernel_inject_false_on_the_card(cuda_device):
    """``execute(kernel_inject=False)`` on the card takes the fused path
    with the source injected into the field (one B1 launch per step, no
    chunk) and agrees with the same call on the CPU and with the card's
    default route (the mega path); bound 1e-5 per unit of peak."""
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
    runs = []
    for device, inject in ((cuda_device, False), ("cpu", False),
                           (cuda_device, True)):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                                  device=device)
        source, receiver, n, _ = wgrun.canonical_problem(
            mesh, (0.7, 0.8, 0.6), (0.7, 0.8, 1.3), 0.09)
        before = tbf.fused_step.launches, tbm.mega_chunk.launches
        out = wgrun.execute(mesh, source, receiver, n, kernel_inject=inject)
        launched = (tbf.fused_step.launches - before[0],
                    tbm.mega_chunk.launches - before[1])
        if device == "cpu":
            assert launched == (0, 0)
        else:
            assert launched == ((0, -(-n // tbm.DEFAULT_CHUNK)) if inject
                                else (n, 0))
        assert bool(out["stable"])
        runs.append(tuple(t.cpu() for t in out["outputs"]))
    (want_i, want_p) = runs[1]
    peak = float(want_p.abs().max())
    for got_i, got_p in (runs[0], runs[2]):
        assert float((got_p - want_p).abs().max()) <= ATOL * max(1.0, peak)
        assert float((got_i - want_i).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode,on_plane", [(0, None), (1, 4), (2, 1)])
def test_mega_chunk_kernel_matches_plain(cuda_device, mode, on_plane):
    """One K = 8 chunk of B2 on random fields, state and planes (zero in
    the planes' padding) against ``_mega_chunk_plain``; in place, one
    launch, and (cur, prev) in the reference's order."""
    spec = tbf.BoxSpec(dims=(21, 17, 26), ilo=(2, 3, 2), ihi=(18, 13, 23),
                       face_surface=(0,) * 6)
    order, K = 6, 8
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device=cuda_device)
    mask = torch.zeros((6, Umax, Vmax), device=cuda_device)
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    src = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    if on_plane is not None:
        a, side = divmod(on_plane, 2)
        src[a] = spec.ilo[a] if side == 0 else spec.ihi[a]
    X, Y, Z = spec.dims
    flat = (src[0] * Y + src[1]) * Z + src[2]
    taps = torch.tensor([flat, flat + 1, 7], device=cuda_device)
    fb = torch.tensor([[1.0, 0.1, 0.05, 0.0, 0.0, 0.0, 0.0]] * 6,
                      device=cuda_device) * 2.0
    fa = torch.tensor([[1.0, -0.2, 0.01, 0.0, 0.0, 0.0, 0.0]] * 6,
                      device=cuda_device)
    state = (rnd(*spec.dims), rnd(*spec.dims),
             rnd(order, 6, Umax, Vmax) * mask, rnd(3, 6, Umax, Vmax) * mask)
    args = (spec, rnd(K), fb, fa)
    want = tbm._mega_chunk_plain(*args, *state, tuple(src) + (mode,), taps)
    mine = tuple(t.clone() for t in state)
    before = tbm.mega_chunk.launches
    got = tbm.mega_chunk(*args, *mine, tuple(src) + (mode,), taps)
    torch.cuda.synchronize()
    assert tbm.mega_chunk.launches == before + 1
    assert all(g.data_ptr() == m.data_ptr() for g, m in zip(got[:4], mine))
    peak = max(float(w.abs().max()) for w in want[:5])
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= MEGA_REL * peak


# ---------------------------------------------------------------------------
# the gradient path: B5, B6, B7

def _rel(got, want):
    return float((got - want).abs().max()) / \
        max(float(want.abs().max()), 1e-30)


# (dims, box (ilo, ihi) or None for the interior [2, dim - 3], shard (x
# offset, rows) or None, source (global x, y, z), mode, cotangents): B5's
# warps are 32 consecutive nodes of the flattened (y, z) plane, each on the
# bare, z-only or general path in each row
FUSED_BWD_CASES = [
    ((16, 16, 128), None, None, (8, 9, 64), 0, "random"),
    ((16, 16, 128), None, None, (8, 9, 64), 1, "random"),
    ((37, 29, 53), None, None, (2, 14, 26), 2, "random"),
    ((37, 29, 53), None, (30, 7), (33, 14, 26), 1, "random"),  # no low x
    ((37, 29, 53), None, (10, 9), (12, 14, 26), 1, "random"),  # no x plane
    # sums that overflow, inf and NaN; all -0 (G = g + 0.f is +0)
    ((37, 29, 53), None, None, (18, 14, 26), 1, "1e38 inf nan"),
    ((37, 29, 53), None, (10, 9), (12, 14, 26), 1, "1e38 inf nan"),
    ((16, 16, 128), None, None, (8, 9, 64), 1, "all -0"),
    ((37, 29, 53), None, (30, 7), (33, 14, 26), 1, "all -0"),
    # Y·Z < 32: one warp with dead lanes (planes at the grid's edge)
    ((9, 4, 7), ((2, 1, 2), (6, 2, 4)), None, (4, 2, 3), 1, "random"),
    ((9, 4, 7), ((2, 1, 2), (6, 2, 4)), (3, 2), (4, 2, 3), 1, "all -0"),
    # shards of one and two rows
    ((37, 29, 53), None, (20, 1), (20, 14, 26), 1, "random"),
    ((37, 29, 53), None, (0, 1), (0, 14, 26), 1, "random"),
    ((37, 29, 53), None, (20, 2), (21, 14, 26), 1, "random"),
    # a source on each side of a warp edge: p = 32 * 24 at (14, 26)
    ((37, 29, 53), None, None, (18, 14, 25), 1, "random"),
    ((16, 16, 128), None, None, (8, 9, 31), 1, "random"),
    ((16, 16, 128), None, None, (8, 9, 32), 1, "random"),
    # the hall with its centre source, and its second shard of four
    (HALL, None, None, (112, 112, 128), 1, "random"),
    (HALL, None, (56, 56), (84, 112, 128), 1, "all -0"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,box,shard,src,mode,kind", FUSED_BWD_CASES)
def test_fused_step_bwd_kernel_matches_plain(cuda_device, dims, box, shard,
                                             src, mode, kind):
    """B5 against ``_fused_step_bwd_plain`` to the bit (``bits_equal``: NaN
    for NaN, −0 apart from +0) in gcur, gprev, the six plane cotangents and
    the two halo cotangents; one launch."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal, case_g
    ilo, ihi = box or ((2, 2, 2), tuple(d - 3 for d in dims))
    off, X = shard or (0, dims[0])
    shape = (X,) + dims[1:]
    geom = (off, 0, 0, ilo[0], ihi[0], ilo[1], ihi[1], ilo[2], ihi[2])
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    g = case_g(kind, shape, gen)
    ginner = tuple(case_g(kind, s, gen) for s in tbf._plane_shapes(*shape))
    args = (geom, g, ginner, src + (mode,))
    before = tbf.fused_step_bwd.launches
    got = tbf.fused_step_bwd(*args)
    assert tbf.fused_step_bwd.launches == before + 1
    want = tbf._fused_step_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda r: (r[0], r[1], *r[2], *r[3])  # noqa: E731
    for q, (a, b) in enumerate(zip(flat(got), flat(want))):
        assert bits_equal(a, b), q


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [HALL, (56,) + HALL[1:]])
def test_fused_step_bwd_occupancy(cuda_device, dims):
    """What the card makes of B5: no local memory, at most 32 registers
    (its launch bounds: 2,048 threads an SM), and CTAs of (y, z) nodes each
    walking ``BWD_WALK`` x rows (the wrapper's launch check) cover the
    field, at the hall and at its shard."""
    X, Y, Z = dims
    occ = tbf.step_bwd_occupancy(cuda_device, dims)
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 32, occ
    assert occ["ctas_per_sm"] * occ["threads"] >= 2048, occ
    assert occ["grid"] == -(-Y * Z // occ["threads"]) \
        * -(-X // tbf.BWD_WALK), occ


def test_fused_step_bwd_refuses_fields_of_2_31_nodes():
    """B5's node indices are 32-bit: the wrapper refuses a field of 2^31
    nodes or more, one with more x rows than its launch covers (65,535
    walks of ``BWD_WALK`` rows) and an empty one, before it builds or
    launches anything.  No card needed: the geometry check runs first."""
    assert tbf._bwd_geometry(*HALL) is None
    big = (2 ** 31 // (HALL[1] * HALL[2]) + 1,) + HALL[1:]
    assert "32-bit" in tbf._bwd_geometry(*big)
    assert tbf._bwd_geometry(big[0] - 1, *big[1:]) is None
    assert tbf._bwd_geometry(65535 * tbf.BWD_WALK, 1, 1) is None
    assert "launch" in tbf._bwd_geometry(65535 * tbf.BWD_WALK + 1, 1, 1)
    assert tbf._bwd_geometry(0, 224, 256) == "is empty"
    g = torch.empty(big, device="meta")
    ginner = tuple(torch.empty(s, device="meta")
                   for s in tbf._plane_shapes(*big))
    geom = (0, 0, 0, 2, big[0] - 3, 2, 221, 2, 253)
    with pytest.raises(ValueError, match="32-bit"):
        tbf._fused_step_bwd_cuda(geom, g, ginner, (0, 0, 0, 0))


def _chunk_case(device, mode, on_plane, K=8, order=6, box=None, taps=None):
    """The unaligned 21 x 17 x 26 box (or ``box``: dims, ilo, ihi) with
    random fields, state and planes (zero in the planes' padding), a source
    in the middle, on an inner plane (an int), on the inner x-lo/y-hi edge
    ("edge") or the inner x-hi/y-lo/z-hi corner ("corner"), and taps at the
    source, beside it and at a boundary node, or ``taps(spec, src)``'s."""
    dims, ilo, ihi = box or ((21, 17, 26), (2, 3, 2), (18, 13, 23))
    spec = tbf.BoxSpec(dims=dims, ilo=ilo, ihi=ihi, face_surface=(0,) * 6)
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    gen = torch.Generator(device=device).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    mask = torch.zeros((6, Umax, Vmax), device=device)
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    src = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    sides = {"edge": (0, 1, None), "corner": (1, 0, 1)}.get(on_plane)
    if sides is None and on_plane is not None:
        sides = tuple(on_plane % 2 if a == on_plane // 2 else None
                      for a in range(3))
    for a, side in enumerate(sides or ()):
        if side is not None:
            src[a] = spec.ilo[a] if side == 0 else spec.ihi[a]
    _, Y, Z = spec.dims
    flat = (src[0] * Y + src[1]) * Z + src[2]
    taps = torch.tensor(taps(spec, src) if taps else
                        [flat, flat + 1, (1 * Y + 5) * Z + 7], device=device)
    # order up to 8; the fitted filters are of order 6
    fb = torch.tensor([[1.0, 0.1, 0.05, 0.02, 0.0, 0.01, 0.0, 0.01, 0.0]]
                      * 6, device=device) * 2.0
    fa = torch.tensor([[1.0, -0.2, 0.01, 0.0, 0.03, 0.0, 0.0, 0.01, 0.0]]
                      * 6, device=device)
    fb = fb + 0.01 * torch.arange(6, device=device)[:, None]
    return dict(spec=spec, rnd=rnd, mask=mask, src=tuple(src) + (mode,),
                taps=taps, fb=fb[:, :order + 1].contiguous(),
                fa=fa[:, :order + 1].contiguous(), K=K, order=order,
                Umax=Umax, Vmax=Vmax)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,on_plane", [(0, None), (1, 4), (2, 1)])
def test_mega_chunk_grad_mode_kernel_matches_plain(cuda_device, mode,
                                                   on_plane):
    """B6: the grad-mode chunk's forward outputs equal the plain chunk
    kernel's (B2) to the bit, its residual block equals the plain version's,
    and it counts in ``grad_launches`` only."""
    c = _chunk_case(cuda_device, mode, on_plane)
    spec, rnd, mask = c["spec"], c["rnd"], c["mask"]
    state = (rnd(*spec.dims), rnd(*spec.dims),
             rnd(c["order"], 6, c["Umax"], c["Vmax"]) * mask,
             rnd(3, 6, c["Umax"], c["Vmax"]) * mask)
    args = (spec, rnd(c["K"]), c["fb"], c["fa"])
    tail = (c["src"], c["taps"])
    want = tbm._mega_chunk_plain(*args, *state, *tail, grad=True)
    b2 = tbm.mega_chunk(*args, *(t.clone() for t in state), *tail)
    before = tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches
    got = tbm.mega_chunk(*args, *(t.clone() for t in state), *tail,
                         grad=True)
    torch.cuda.synchronize()
    assert (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches) == \
        (before[0], before[1] + 1)
    assert len(got) == 7 and len(b2) == 6
    for a, b in zip(got[:6], b2):
        assert torch.equal(a, b)
    assert tuple(got[6].shape) == (c["K"], 4, 6, c["Umax"], c["Vmax"])
    assert _rel(got[6], want[6]) <= BWD_REL


# the boxes of the persistent chunk kernels' tests: the unaligned box, whose
# z extent holds no bare z block, and one whose nodes outnumber the grid's
# threads and whose rows hold bare blocks
SMALL_BOX = ((21, 17, 26), (2, 3, 2), (18, 13, 23))
LARGE_BOX = ((40, 60, 100), (2, 3, 2), (37, 56, 97))


def _bare_node(spec, src):
    """A node of LARGE_BOX inside a bare z block (z 32..63, strictly inside
    the box on every axis) and off the source's row."""
    _, Y, Z = spec.dims
    return (10 * Y + 20) * Z + 40


def _tap_in_bare_block(spec, src):
    _, Y, Z = spec.dims
    flat = (src[0] * Y + src[1]) * Z + src[2]
    return [flat, flat + 1, _bare_node(spec, src)]


def _duplicated_taps(spec, src):
    _, Y, Z = spec.dims
    flat = (src[0] * Y + src[1]) * Z + src[2]
    bare = _bare_node(spec, src)
    return [flat, bare, flat, flat + 1, bare, bare]


def _far_from_planes_and_taps(spec, K, taps):
    """Nodes farther than K + 1 (Manhattan) from every boundary plane,
    inner plane and tap: what K sub-steps carry from the plane transpose,
    whose order of sums differs from the plain version's, and from the
    taps, whose duplicates the plain version adds with atomics, does not
    reach them."""
    X, Y, Z = spec.dims
    dev = taps.device
    g = [torch.arange(n, device=dev) for n in (X, Y, Z)]
    far = torch.ones((X, Y, Z), dtype=torch.bool, device=dev)
    for a in range(3):
        d = torch.minimum((g[a] - (spec.ilo[a] - 1)).abs(),
                          (g[a] - (spec.ihi[a] + 1)).abs())
        shape = [1, 1, 1]
        shape[a] = -1
        far &= (d > K + 1).view(shape)
    for n in taps.tolist():
        t = (n // (Y * Z), n // Z % Y, n % Z)
        dist = sum((g[a] - t[a]).abs().view([-1 if b == a else 1
                                             for b in range(3)])
                   for a in range(3))
        far &= dist > K + 1
    return far


def _agree_where_plain_is_not_nan(got, want):
    """Inputs at 1e38: where the plain version is finite the kernel is too
    and within BWD_REL of the largest finite value; where it is infinite
    the kernel has the same infinity.  Where it is NaN the kernel is left
    free: the plain version's transpose of the edge coupling sums a
    broadcast line, 0 * inf = NaN from every element along it, which the
    kernel's gather of the coupled planes does not form."""
    finite, inf = torch.isfinite(want), torch.isinf(want)
    if not torch.equal(got[inf], want[inf]):
        return False
    if not finite.any():
        return True
    g, w = got[finite], want[finite]
    return bool(torch.isfinite(g).all()) and \
        float((g - w).abs().max()) <= BWD_REL * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,on_plane,K,order,box,taps,scale", [
    (0, None, 8, 6, None, None, 1.0),
    (1, 4, 8, 6, None, None, 1.0),
    (2, 1, 8, 6, None, None, 1.0),
    (1, 2, 6, 3, None, None, 1.0),
    (2, 5, 4, 1, None, None, 1.0),
    (1, None, 8, 6, LARGE_BOX, _tap_in_bare_block, 1.0),
    (2, None, 4, 6, LARGE_BOX, _duplicated_taps, 1.0),
    (1, "edge", 8, 6, None, None, 1.0),
    (1, "corner", 8, 6, None, None, 1.0),
    (1, "edge", 4, 6, LARGE_BOX, None, 1.0),
    (1, None, 2, 1, None, None, 1.0),
    (2, "corner", 2, 1, LARGE_BOX, _duplicated_taps, 1.0),
    (2, 3, 4, 8, None, None, 1.0),        # more state slots than one load
    (2, None, 8, 6, None, None, 1e38),
    (1, 0, 4, 3, LARGE_BOX, _tap_in_bare_block, 1e38),
])
def test_mega_chunk_bwd_kernel_matches_plain(cuda_device, mode, on_plane, K,
                                             order, box, taps, scale):
    """B7 on random cotangents against ``_mega_chunk_bwd_plain``: each of
    the six outputs within 1e-5 of its largest value, the streams plane by
    plane; one launch.  The cases: sources in the middle, on inner planes,
    a hard source on an inner edge and a corner; a tap inside a bare z
    block and taps repeated; K from 2 to 8, order 1 to 8; and cotangents at
    1e38, where sums overflow (``_agree_where_plain_is_not_nan``).  The
    fields are equal to the bit at nodes that the plane transpose and the
    taps do not reach in K sub-steps."""
    c = _chunk_case(cuda_device, mode, on_plane, K, order, box, taps)
    spec, rnd, mask = c["spec"], c["rnd"], c["mask"]
    cot = tuple((t * scale).contiguous() for t in (
        rnd(K, c["taps"].numel()), rnd(*spec.dims), rnd(*spec.dims),
        rnd(order, 6, c["Umax"], c["Vmax"]) * mask))
    want = tbm._mega_chunk_bwd_plain(spec, c["fb"], c["fa"], *cot, c["src"],
                                     c["taps"])
    before = tbm.mega_chunk_bwd.launches
    got = tbm.mega_chunk_bwd(spec, c["fb"], c["fa"],
                             *(t.clone() for t in cot), c["src"], c["taps"])
    torch.cuda.synchronize()
    assert tbm.mega_chunk_bwd.launches == before + 1
    names = ("gnext", "gcur", "gst", "gsig", "gp_stream", "gstin_stream")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        if mode == 0 and name == "gsig":
            assert float(a.abs().max()) == 0.0
        elif scale > 1.0:
            assert _agree_where_plain_is_not_nan(a, b), name
        else:
            assert _rel(a, b) <= BWD_REL, name
    if scale > 1.0:
        assert not bool(torch.isfinite(want[0]).all())   # sums overflowed
        return
    for name, a, b, axis in (("gp_stream", got[4], want[4], 1),
                             ("gstin_stream", got[5], want[5], 2)):
        scale = float(b.abs().max())
        for q in range(6):
            err = float((a.select(axis, q) - b.select(axis, q)).abs().max())
            assert err <= BWD_REL * scale, (name, q)
    far = _far_from_planes_and_taps(spec, K, c["taps"])
    for name, a, b in zip(names[:2], got, want):
        assert torch.equal(a[far], b[far]), name


# the persistent chunk kernel (B2, and B6 in grad mode): one cooperative
# launch a chunk, held to the bit


def _nan_equal(a, b):
    """torch.equal, with NaN equal to NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(na, nb) and torch.equal(torch.where(na, zero, a),
                                               torch.where(nb, zero, b))


def _persistent_case(device, box, where, mode, K, order, scale, seed=5):
    """A chunk problem on ``box`` (dims, ilo, ihi) with random fields, state
    and planes (zero in the planes' padding) times ``scale``; the source in
    the middle (``where`` None), on inner plane ``where`` (an int), on the
    x-lo/y-hi edge ("edge") or the x-hi/y-lo/z-hi corner ("corner"), with
    taps at the source, beside it and at two far nodes."""
    dims, ilo, ihi = box
    spec = tbf.BoxSpec(dims=dims, ilo=ilo, ihi=ihi, face_surface=(0,) * 6)
    Umax, Vmax = tbf.stacked_plane_shape(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    mask = torch.zeros((6, Umax, Vmax), device=device)
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    sides = {None: (None,) * 3, "edge": (0, 1, None),
             "corner": (1, 0, 1)}.get(where)
    if sides is None:
        sides = tuple(where % 2 if a == where // 2 else None
                      for a in range(3))
    src = tuple((ilo[a] + ihi[a]) // 2 if side is None
                else (ilo[a] if side == 0 else ihi[a])
                for a, side in enumerate(sides))
    X, Y, Z = dims
    flat = (src[0] * Y + src[1]) * Z + src[2]
    taps = torch.tensor([flat, flat + 1, (1 * Y + 5) * Z + 7,
                         X * Y * Z - 1], device=device)
    fb = torch.tensor([[1.0, 0.1, 0.05, 0.02, 0.0, 0.01, 0.0]] * 6,
                      device=device) * 2.0
    fa = torch.tensor([[1.0, -0.2, 0.01, 0.0, 0.03, 0.0, 0.0]] * 6,
                      device=device)
    fb = (fb + 0.01 * torch.arange(6, device=device)[:, None])
    state = tuple((t * scale).contiguous() for t in (
        rnd(*dims), rnd(*dims), rnd(order, 6, Umax, Vmax) * mask,
        rnd(3, 6, Umax, Vmax) * mask))
    return (spec, rnd(K), fb[:, :order + 1].contiguous(),
            fa[:, :order + 1].contiguous()), state, (src + (mode,), taps)


@pytest.mark.cuda
@pytest.mark.parametrize("box,where,mode,K,order,scale", [
    (SMALL_BOX, None, 0, 8, 6, 1.0),
    (SMALL_BOX, None, 1, 8, 6, 1.0),
    (SMALL_BOX, None, 2, 8, 6, 1.0),
    *((SMALL_BOX, p, 1 + p % 2, 8, 6, 1.0) for p in range(6)),
    (SMALL_BOX, "edge", 2, 8, 6, 1.0),
    (SMALL_BOX, "corner", 1, 8, 6, 1.0),
    (SMALL_BOX, "corner", 2, 2, 6, 1.0),
    (SMALL_BOX, 3, 2, 8, 1, 1.0),
    (SMALL_BOX, None, 1, 2, 1, 1.0),
    (LARGE_BOX, None, 1, 8, 6, 1.0),
    (LARGE_BOX, "edge", 2, 2, 6, 1.0),
    (SMALL_BOX, None, 2, 8, 6, 1e38),     # sums overflow: bad counts agree
    (LARGE_BOX, 0, 1, 8, 3, 1e38),
])
def test_mega_chunk_persistent_bit_equal(cuda_device, box, where, mode, K,
                                         order, scale):
    """B2 and B6 against ``_mega_chunk_plain``, to the bit (NaN where the
    plain version has NaN): the fields, state, planes, taps and non-finite
    count; B6's six outputs equal B2's and its residual block the plain
    version's.  One launch each, in its own counter."""
    args, state, tail = _persistent_case(cuda_device, box, where, mode, K,
                                         order, scale)
    want = tbm._mega_chunk_plain(*args, *state, *tail, grad=True)
    before = tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches
    b2 = tbm.mega_chunk(*args, *(t.clone() for t in state), *tail)
    torch.cuda.synchronize()
    assert (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches) == \
        (before[0] + 1, before[1])
    b6 = tbm.mega_chunk(*args, *(t.clone() for t in state), *tail,
                        grad=True)
    torch.cuda.synchronize()
    assert (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches) == \
        (before[0] + 1, before[1] + 1)
    names = ("cur", "prev", "st", "pln", "taps", "bad")
    for name, g, w in zip(names, b2, want):
        assert _nan_equal(g, w), name
    for name, g, w in zip(names, b6, b2):
        assert _nan_equal(g, w), name
    assert _nan_equal(b6[6], want[6]), "residuals"
    if scale > 1.0:
        assert float(want[5]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
def test_mega_chunk_persistent_chunks_chain(cuda_device, grad):
    """Two K = 4 chunks of the kernel equal one K = 8 chunk to the bit:
    fields, state, planes, taps, the non-finite count and (grad mode) the
    residuals."""
    args, state, tail = _persistent_case(cuda_device, LARGE_BOX, "corner", 2,
                                         8, 6, 1.0)
    spec, sig, fb, fa = args
    whole = tbm.mega_chunk(*args, *(t.clone() for t in state), *tail,
                           grad=grad)
    half = tbm.mega_chunk(spec, sig[:4].contiguous(), fb, fa,
                          *(t.clone() for t in state), *tail, grad=grad)
    half = tuple(t.clone() for t in half)
    half2 = tbm.mega_chunk(spec, sig[4:].contiguous(), fb, fa, *half[:4],
                           *tail, grad=grad)
    torch.cuda.synchronize()
    for g, w in zip(half2[:4], whole[:4]):
        assert torch.equal(g, w)
    assert torch.equal(torch.cat([half[4], half2[4]]), whole[4])
    assert torch.equal(half[5] + half2[5], whole[5])
    if grad:
        assert torch.equal(torch.cat([half[6], half2[6]]), whole[6])


@pytest.mark.cuda
def test_mega_chunk_residency(cuda_device):
    """What the card makes of the chunk kernel: no local memory, at most 64
    registers (its launch bounds), and a cooperative grid of every CTA the
    card holds at once, CTAs an SM x SMs."""
    occ = tbm.chunk_occupancy(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 64, occ
    assert occ["ctas_per_sm"] >= 1, occ
    assert occ["grid"] == occ["ctas_per_sm"] * sms, occ


@pytest.mark.cuda
def test_mega_chunk_bwd_persistent_one_launch(cuda_device):
    """B7 is one cooperative launch a chunk: a profiled K = 8 chunk shows
    one ``mega_chunk_bwd_kernel`` and no other adjoint kernel; and what the
    card makes of it: no local memory, at most 64 registers, a grid of
    CTAs an SM x SMs."""
    from wayverb_tpu_torch.tools.mega_timing import profile
    c = _chunk_case(cuda_device, 1, "edge", 8, 6, LARGE_BOX,
                    _tap_in_bare_block)
    spec, rnd, mask = c["spec"], c["rnd"], c["mask"]
    cot = (rnd(8, c["taps"].numel()), rnd(*spec.dims), rnd(*spec.dims),
           rnd(6, 6, c["Umax"], c["Vmax"]) * mask)
    prof = profile(lambda: tbm.mega_chunk_bwd(
        spec, c["fb"], c["fa"], *(t.clone() for t in cot), c["src"],
        c["taps"]), "bwd_")
    names = [n for n in prof["kernels"] if "bwd_" in n]
    assert prof["chunk_launches"] == 1, prof["kernels"]
    assert len(names) == 1 and "mega_chunk_bwd_kernel" in names[0], names
    occ = tbm.chunk_bwd_occupancy(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 64, occ
    assert occ["ctas_per_sm"] >= 1, occ
    assert occ["grid"] == occ["ctas_per_sm"] * sms, occ


def _grad_problem(device, steps):
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.shoebox_mesh(Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8)),
                              np.full((1, 8), 0.12), dx, fs, device=device)
    source, receiver, _, _ = wgrun.canonical_problem(
        mesh, (0.7, 0.8, 0.5), (0.7, 0.8, 1.3), (steps - 0.5) / fs)
    return mesh, source, receiver


def _leaves(mesh, source):
    cb = mesh.structure.coef_b.clone().requires_grad_(True)
    ca = mesh.structure.coef_a.clone().requires_grad_(True)
    sig = source.signal.clone().requires_grad_(True)
    return (dataclasses.replace(mesh.structure, coef_b=cb, coef_a=ca),
            dataclasses.replace(source, signal=sig), (cb, ca, sig))


@pytest.mark.cuda
def test_gradients_on_the_card_match_cpu(cuda_device):
    """Gradients of Σ pressure² with respect to coef_b, coef_a and the
    signal on the card, through the mega route (3 B6 launches forward, 3 B7
    backward, no B2) and through the fused route with
    ``kernel_inject=False`` (one B1 launch per step, one B5 launch per step
    whose field reaches a tap), against the
    same gradients from the plain versions on the CPU; within 1e-4 of the
    largest component."""
    steps = 20
    grads = {}
    for device, route in ((cuda_device, "mega"), (cuda_device, "fused"),
                          ("cpu", "mega")):
        mesh, source, receiver = _grad_problem(device, steps)
        structure, source, leaves = _leaves(mesh, source)
        before = (tbf.fused_step.launches, tbf.fused_step_bwd.launches,
                  tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches,
                  tbm.mega_chunk_bwd.launches)
        if route == "mega":
            out = tbm.run_waveguide_box_mega(structure, mesh.box_spec, source,
                                             receiver, steps, chunk=8)
        else:
            out = wgrun.run_waveguide_box(structure, mesh.box_spec, source,
                                          receiver, steps,
                                          kernel_inject=False)
        pressure = out["outputs"][1]
        assert pressure.requires_grad and bool(out["stable"])
        torch.sum(pressure ** 2).backward()
        launched = tuple(now - was for now, was in zip(
            (tbf.fused_step.launches, tbf.fused_step_bwd.launches,
             tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches,
             tbm.mega_chunk_bwd.launches), before))
        if device == "cpu":
            assert launched == (0, 0, 0, 0, 0)
        elif route == "mega":
            assert launched == (0, 0, 0, 3, 3)
        else:
            # the last step's field reaches no tap, so its adjoint never runs
            assert launched == (steps, steps - 1, 0, 0, 0)
        grads[(str(device), route)] = tuple(t.grad.cpu() for t in leaves)
    want = grads[("cpu", "mega")]
    for key in ((str(cuda_device), "mega"), (str(cuda_device), "fused")):
        for a, b in zip(grads[key], want):
            assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
            assert _rel(a, b) <= GRAD_REL, key


@pytest.mark.cuda
def test_execute_on_the_card_differentiates_or_raises(cuda_device):
    """A loss built on ``execute`` and ``canonical`` on the card with inputs
    that require grad has a graph and yields gradients through B6/B7 (the
    default route) or B1/B5 (``kernel_inject=False``); with nothing
    requiring grad the forward launches B2 as before and has no graph."""
    steps = 16
    mesh, source, receiver = _grad_problem(cuda_device, steps)
    for inject in (True, False):
        structure, src, (cb, ca, sig) = _leaves(mesh, source)
        m = dataclasses.replace(mesh, structure=structure)
        before = (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches,
                  tbm.mega_chunk_bwd.launches, tbf.fused_step_bwd.launches)
        out = wgrun.execute(m, src, receiver, steps, kernel_inject=inject)
        pressure = out["outputs"][1]
        assert pressure.grad_fn is not None
        torch.sum(pressure ** 2).backward()
        after = (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches,
                 tbm.mega_chunk_bwd.launches, tbf.fused_step_bwd.launches)
        launched = tuple(b - a for a, b in zip(before, after))
        assert launched == ((0, 1, 1, 0) if inject
                            else (0, 0, 0, steps - 1))
        for leaf in (cb, ca, sig):
            assert leaf.grad is not None and float(leaf.grad.abs().max()) > 0
    before = tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches
    out = wgrun.execute(mesh, source, receiver, steps)
    assert (tbm.mega_chunk.launches, tbm.mega_chunk.grad_launches) == \
        (before[0] + 1, before[1])
    assert out["outputs"][1].grad_fn is None
    structure, _, _ = _leaves(mesh, source)
    m = dataclasses.replace(mesh, structure=structure)
    out = wgrun.canonical(m, (0.7, 0.8, 0.5), (0.7, 0.8, 1.3),
                          (steps - 0.5) / 3333.33)
    assert out.pressure.grad_fn is not None


@pytest.mark.cuda
def test_signal_only_run_on_the_card_has_a_graph(cuda_device):
    """Only the source signal requires grad.  The fused route with the
    injection inside the step (B1 forward, B5 backward) still returns a
    result with a graph and the signal gradient is zero; the mega route
    gives the exact signal gradient of ``kernel_inject=False`` without
    building the coefficient gradients."""
    steps = 16
    mesh, source, receiver = _grad_problem(cuda_device, steps)
    sig = source.signal.clone().requires_grad_(True)
    before = tbf.fused_step_bwd.launches
    out = wgrun.run_waveguide_box(
        mesh.structure, mesh.box_spec, dataclasses.replace(source, signal=sig),
        receiver, steps)
    pressure = out["outputs"][1]
    assert pressure.grad_fn is not None
    torch.sum(pressure ** 2).backward()
    assert tbf.fused_step_bwd.launches == before + steps - 1
    assert sig.grad is not None and not bool(sig.grad.any())

    grads = []
    for inject in (True, False):
        sig = source.signal.clone().requires_grad_(True)
        out = wgrun.execute(mesh, dataclasses.replace(source, signal=sig),
                            receiver, steps, kernel_inject=inject)
        torch.sum(out["outputs"][1] ** 2).backward()
        grads.append(sig.grad.cpu())
    assert float(grads[1].abs().max()) > 0
    assert _rel(grads[0], grads[1]) <= GRAD_REL


# ---------------------------------------------------------------------------
# the general mesh: B8, B9, B12

def _mesh_case(dims, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda: torch.randn(*dims, generator=gen,  # noqa: E731
                              device=device)
    code = torch.randint(0, 1 << 13, dims, generator=gen, device=device,
                         dtype=torch.int32)
    mask = (torch.rand(*dims, generator=gen, device=device) > 0.3).float()
    return rnd(), rnd(), code, mask


MESH_DIMS = [(6, 7, 9), (16, 8, 128), (37, 29, 53), (3, 2, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", MESH_DIMS)
def test_weighted_step_kernel_matches_plain(cuda_device, dims):
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    cur, prev, code, _ = _mesh_case(dims, cuda_device)
    before = tsk.weighted_step.launches
    got = tsk.weighted_step(cur, prev, code)
    assert tsk.weighted_step.launches == before + 1
    want = tsk._weighted_step_plain(cur, prev, code)
    assert float((got - want).abs().max()) <= ATOL
    # the time loop's form: the result written over prev
    buf = prev.clone()
    assert tsk.weighted_step(cur, buf, code, out=buf) is buf
    torch.cuda.synchronize()
    assert float((buf - want).abs().max()) <= ATOL


def _b9_bit_equal(g, code):
    """B9 (one launch) against its plain version, to the bit
    (``bits_equal``: NaN for NaN, −0 apart from +0)."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    before = tsk.weighted_step_bwd.launches
    got = tsk.weighted_step_bwd(g, code)
    assert tsk.weighted_step_bwd.launches == before + 1
    want = tsk._weighted_step_bwd_plain(g, code)
    torch.cuda.synchronize()
    assert bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", MESH_DIMS)
def test_weighted_step_bwd_kernel_matches_plain(cuda_device, dims):
    """B9 on random codes, to the bit."""
    g, _, code, _ = _mesh_case(dims, cuda_device, seed=1)
    _b9_bit_equal(g, code)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", MESH_DIMS)
def test_interior_step_kernel_matches_plain(cuda_device, dims):
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    cur, prev, _, mask = _mesh_case(dims, cuda_device, seed=2)
    before = tsk.interior_step.launches
    got = tsk.interior_step(cur, prev, mask)
    assert tsk.interior_step.launches == before + 1
    want = tsk._interior_step_plain(cur, prev, mask)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.cuda
def test_weighted_step_function_on_the_card(cuda_device):
    """The Function's backward launches B9; gradients equal plain
    autograd's through the plain version."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    cur, prev, code, _ = _mesh_case((9, 10, 33), cuda_device, seed=3)
    h = torch.randn_like(cur)
    grads = []
    for fn in (tsk.weighted_step, tsk._weighted_step_plain):
        c = cur.clone().requires_grad_(True)
        p = prev.clone().requires_grad_(True)
        before = tsk.weighted_step_bwd.launches
        torch.sum(fn(c, p, code) * h).backward()
        grads.append((c.grad, p.grad,
                      tsk.weighted_step_bwd.launches - before))
    (gc, gp, n_kernel), (wc, wp, n_plain) = grads
    assert (n_kernel, n_plain) == (1, 0)
    assert float((gc - wc).abs().max()) <= ATOL
    assert float((gp - wp).abs().max()) <= ATOL


@pytest.mark.cuda
def test_mesh_kernels_reject_what_they_cannot_take(cuda_device):
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    cur, prev, code, mask = _mesh_case((6, 7, 9), cuda_device)
    with pytest.raises(ValueError):
        tsk.weighted_step(cur.double(), prev.double(), code)
    with pytest.raises(ValueError):
        tsk.weighted_step(cur, prev, code.long())
    with pytest.raises(ValueError):
        tsk.weighted_step(cur, prev, code, out=cur)
    with pytest.raises(ValueError):
        tsk.weighted_step(cur.transpose(1, 2).contiguous().transpose(1, 2),
                          prev, code)
    with pytest.raises(ValueError):
        tsk.weighted_step_bwd(cur, code.cpu())
    with pytest.raises(ValueError):
        tsk.interior_step(cur, prev, mask[:5])
    with pytest.raises(ValueError):
        tsk.interior_step(cur.clone().requires_grad_(True), prev, mask)


def _small_columns_hall(device):
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    fs = 400.0 / (0.25 * 0.6)
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.compute_mesh(procedural_hall(2, 4, 1)[0],
                              np.full((1, 8), 0.1), dx, fs, device=device)
    return mesh, fs


@pytest.mark.cuda
def test_general_canonical_on_the_card_matches_cpu(cuda_device):
    """``canonical`` on a hall with columns: one B8 launch per step on the
    card, none on the CPU; 1e-5 per unit of peak."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    outs = []
    for device in (cuda_device, "cpu"):
        mesh, fs = _small_columns_hall(device)
        assert mesh.box_spec is None and mesh.regions is None
        before = tsk.weighted_step.launches, tbm.mega_chunk.launches
        outs.append(wgrun.canonical(mesh, (6.0, 4.0, 5.0), (7.5, 3.0, 6.5),
                                    99.5 / fs))
        assert (tsk.weighted_step.launches - before[0],
                tbm.mega_chunk.launches - before[1]) == \
            ((100, 0) if device == cuda_device else (0, 0))
    card, cpu = outs
    assert bool(card.stable) and bool(cpu.stable)
    peak = float(cpu.pressure.abs().max())
    assert float((card.pressure.cpu() - cpu.pressure).abs().max()) <= \
        ATOL * max(1.0, peak)
    assert float((card.intensity.cpu() - cpu.intensity).abs().max()) <= ATOL


@pytest.mark.cuda
def test_thin_box_on_the_card_matches_cpu(cuda_device):
    """A box two nodes thin takes the region path: one B12 launch per step
    on the card; 1e-5 per unit of peak against the CPU run."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 0.5))
    outs = []
    for device in (cuda_device, "cpu"):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                                  anchor=(0.7, 0.8, 0.25 + dx / 2),
                                  device=device)
        assert mesh.box_spec is None and len(mesh.regions) == 26
        before = tsk.interior_step.launches
        outs.append(wgrun.canonical(mesh, (0.5, 0.6, 0.2), (0.9, 1.1, 0.3),
                                    0.03))
        assert tsk.interior_step.launches - before == \
            (100 if device == cuda_device else 0)
    card, cpu = outs
    peak = float(cpu.pressure.abs().max())
    assert bool(card.stable) and bool(cpu.stable)
    assert float((card.pressure.cpu() - cpu.pressure).abs().max()) <= \
        ATOL * max(1.0, peak)


@pytest.mark.cuda
def test_general_gradient_on_the_card_matches_cpu(cuda_device):
    """d(Σ taps²)/d(coef_b, coef_a, signal) through ``run_waveguide`` on the
    hall with columns, 48 steps, checkpointed every 16, the source two
    nodes from a column: B9 launches on the card, and the gradients agree
    with the CPU run's within 1e-4 of the largest component."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    steps = 48
    results = []
    for device in (cuda_device, "cpu"):
        mesh, fs = _small_columns_hall(device)
        source, receiver, n, _ = wgrun.canonical_problem(
            mesh, (6.4, 4.0, 8.97), (6.9, 4.0, 8.97), (steps - 0.5) / fs)
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  (mesh.structure.coef_b, mesh.structure.coef_a,
                   source.signal)]
        structure = dataclasses.replace(mesh.structure, coef_b=leaves[0],
                                        coef_a=leaves[1])
        before = tsk.weighted_step_bwd.launches
        out = wgrun.run_waveguide(
            structure, mesh.descriptor.dimensions,
            dataclasses.replace(source, signal=leaves[2]), receiver, n,
            checkpoint_every=16)
        torch.sum(out["outputs"][1] ** 2).backward()
        launched = tsk.weighted_step_bwd.launches - before
        assert (launched > 0) == (device == cuda_device)
        results.append([t.grad.cpu() for t in leaves])
    for got, want in zip(*results):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= GRAD_REL * scale


# ---------------------------------------------------------------------------
# one x-shard of the general mesh: B10, B11

SHARD_DIMS = [(1, 7, 9), (2, 7, 9), (1, 139, 259), (2, 139, 259),
              (5, 37, 53), (86, 139, 259)]


def _shard_case(dims, device, seed):
    cur, prev, code, _ = _mesh_case(dims, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    halos = tuple(torch.randn(1, *dims[1:], generator=gen, device=device)
                  for _ in range(2))
    return cur, prev, code, halos


def _b10_bit_equal(cur, prev, code, halos):
    """B10 against its plain version, to the bit (``bits_equal``: NaN for
    NaN, −0 apart from +0), into a fresh output and into ``out=prev`` (a
    copy of prev, as the sharded time loop passes it), one launch each."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    before = tsk.weighted_step_sharded.launches
    got = tsk.weighted_step_sharded(cur, prev, code, halos)
    assert tsk.weighted_step_sharded.launches == before + 1
    want = tsk._weighted_step_sharded_plain(cur, prev, code, halos)
    buf = prev.clone()
    assert tsk.weighted_step_sharded(cur, buf, code, halos, out=buf) is buf
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert bits_equal(buf, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SHARD_DIMS)
def test_weighted_step_sharded_kernel_matches_plain(cuda_device, dims):
    """B10 with random non-zero halos, one and two rows among the shapes;
    to the bit, as the plain version sums in the kernel's order, into a
    fresh output and into ``out=prev``."""
    cur, prev, code, halos = _shard_case(dims, cuda_device, 4)
    _b10_bit_equal(cur, prev, code, halos)


def _b11_bit_equal(g, code):
    """B11 (one launch) against its plain version, to the bit in ĝcur and
    both halo cotangents (``bits_equal``: NaN for NaN, −0 apart from +0)."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    before = tsk.weighted_step_sharded_bwd.launches
    gcur, ghalos = tsk.weighted_step_sharded_bwd(g, code)
    assert tsk.weighted_step_sharded_bwd.launches == before + 1
    want_cur, want_halos = tsk._weighted_step_sharded_bwd_plain(g, code)
    torch.cuda.synchronize()
    assert bits_equal(gcur, want_cur)
    for got, want in zip(ghalos, want_halos):
        assert got.shape == (1, *g.shape[1:])
        assert bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SHARD_DIMS)
def test_weighted_step_sharded_bwd_kernel_matches_plain(cuda_device, dims):
    """B11: the cur cotangent and both halo cotangents, one and two rows
    among the shapes (at one row a thread writes both halo rows), to the
    bit."""
    g, _, code, _ = _shard_case(dims, cuda_device, 5)
    _b11_bit_equal(g, code)


@pytest.fixture(scope="module")
def columns_shard_code():
    """The second of four x-shards of the small columns hall's weight code
    (400 Hz, x aligned to 4, as ``test_general_sharded_on_the_card_equals_
    single`` builds it), (24, 41, 71): random codes never make a warp
    bare, this one does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from wayverb_tpu_torch.tools.mesh_timing import columns_shard_code
    return columns_shard_code("cuda", cutoff=400.0)


def _case_g(case, shape, gen):
    """g of a B9 or B11 case (``mesh_timing.case_g``)."""
    from wayverb_tpu_torch.tools.mesh_timing import case_g
    kind = case if case in ("1e38 inf nan", "all -0") else "random"
    return case_g(kind, shape, gen)


B11_CASES = [("columns shard", None), ("1e38 inf nan", None),
             ("all -0", None), ("Y*Z < 32", (slice(0, 4), slice(10, 13),
                                             slice(30, 35))),
             ("one row", (slice(5, 6),)), ("two rows", (slice(5, 7),)),
             ("odd Y", (slice(None), slice(0, 33)))]


@pytest.mark.cuda
@pytest.mark.parametrize("case,cut", B11_CASES, ids=[c for c, _ in B11_CASES])
def test_weighted_step_sharded_bwd_kernel_cases(cuda_device,
                                                columns_shard_code, case,
                                                cut):
    """B11 to the bit on a shard of a real mesh's weight code, where bare
    warps meet walls and columns: random g, g at 1e38 with ±inf and NaN,
    all −0, and slices of the shard (Y·Z < 32, X = 1 and 2, odd Y)."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    code = columns_shard_code
    if cut is not None:
        code = code[cut].contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    g = _case_g(case, tuple(code.shape), gen)
    if case == "columns shard":
        assert 0 < int(bare_warps(code).sum()) < bare_warps(code).numel()
    _b11_bit_equal(g, code)


@pytest.mark.cuda
def test_weighted_step_sharded_bwd_occupancy(cuda_device):
    """What the card makes of B11: no local memory, at most 32 registers
    (its launch bounds: 8 CTAs of 256 an SM), and CTAs x threads x 4 rows
    a thread cover the shard."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    dims = (86, 139, 259)
    occ = tsk.shard_bwd_occupancy(cuda_device, dims)
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 32, occ
    assert occ["ctas_per_sm"] >= 8, occ
    assert occ["grid"] * occ["threads"] * 4 >= 86 * 139 * 259, occ


@pytest.mark.cuda
def test_weighted_step_sharded_bwd_follows_a_changed_code(
        cuda_device, columns_shard_code):
    """Each launch decides its bare warps from the code it is given: with
    a neighbour of weight 2 and one of weight 0 put into two bare warps,
    those warps leave the bare path and B11 equals the plain version of
    the changed code to the bit."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    code = columns_shard_code.clone()
    Z = code.shape[2]
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    g = torch.randn(*code.shape, generator=gen, device="cuda")
    _b11_bit_equal(g, code)
    marked = bare_warps(code).nonzero()
    assert len(marked) > 2
    (x1, s1), (x2, s2) = marked[len(marked) // 3], marked[2 * len(marked) // 3]
    # node p1 of warp (x1, s1) gets weight 2 from its -x neighbour; node p2
    # of warp (x2, s2) weight 0 from its +y neighbour
    p1, p2 = 32 * int(s1) + 5, 32 * int(s2) + 17
    code[int(x1) - 1, p1 // Z, p1 % Z] |= 1 << 7
    code[int(x2), p2 // Z + 1, p2 % Z] &= ~((1 << 2) | (1 << 8))
    after = bare_warps(code)
    assert not after[x1, s1] and not after[x2, s2]
    _b11_bit_equal(g, code)


B10_CASES = [("columns shard", None), ("1e38 inf nan", None),
             ("all -0", None), ("Y*Z < 32", (slice(0, 4), slice(10, 13),
                                             slice(30, 35))),
             ("one row", (slice(5, 6),)), ("two rows", (slice(5, 7),)),
             ("weights 2 and 0 in bare warps", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,cut", B10_CASES, ids=[c for c, _ in B10_CASES])
def test_weighted_step_sharded_kernel_cases(cuda_device, columns_shard_code,
                                            case, cut):
    """B10 to the bit on a shard of a real mesh's weight code, where bare
    warps meet walls and columns: random inputs, cur, prev and halos at
    1e38 with ±inf and NaN, all −0, and slices of the shard (Y·Z < 32, one
    and two rows); and the shard's code with one node of a bare warp given
    a weight of 2 and one of another bare warp a weight of 0 towards a
    cur of inf, so both warps decode and the second gives the plain
    version's 0 · inf = NaN."""
    from wayverb_tpu_torch.tools.mesh_timing import b10_inputs
    from wayverb_tpu_torch.tools.mesh_timing import \
        forward_bare_warps as bare
    code = columns_shard_code.clone()
    if cut is not None:
        code = code[cut].contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    kind = case if case in ("1e38 inf nan", "all -0") else "random"
    cur, prev, halos = b10_inputs(kind, tuple(code.shape), gen)
    if case == "columns shard":
        assert 0 < int(bare(code, 32).sum()) < bare(code, 32).numel()
    if case.startswith("weights"):
        Y, Z = code.shape[1:]
        marked = bare(code, 32).nonzero()
        assert len(marked) > 2
        (x1, s1), (x2, s2) = (marked[len(marked) // 3],
                              marked[2 * len(marked) // 3])
        # node p1 of warp (x1, s1) weighs its +x neighbour 2; node p2 of
        # warp (x2, s2) weighs its +y neighbour 0, and that neighbour is inf
        p1, p2 = 32 * int(s1) + 5, 32 * int(s2) + 17
        code[int(x1), p1 // Z, p1 % Z] |= 1 << 7
        code[int(x2), p2 // Z, p2 % Z] &= ~((1 << 3) | (1 << 9))
        cur[int(x2), p2 // Z + 1, p2 % Z] = float("inf")
        after = bare(code, 32)
        assert not after[x1, s1] and not after[x2, s2]
        assert int(after.sum()) == len(marked) - 2
    _b10_bit_equal(cur, prev, code, halos)
    if case.startswith("weights"):
        from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
        out = tsk.weighted_step_sharded(cur, prev, code, halos)
        assert bool(torch.isnan(out[int(x2), p2 // Z, p2 % Z]))


@pytest.mark.cuda
def test_weighted_step_sharded_occupancy(cuda_device):
    """What the card makes of B10: no local memory, at most 32 registers
    (its launch bounds: 2,048 threads an SM; 31 registers and 16 CTAs of
    128 an SM on an H100), and CTAs of (y, z) nodes each walking
    ``SHARD_FWD_WALK`` x rows (the wrapper's launch check) cover the
    columns hall's shard."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    dims = (86, 139, 259)
    occ = tsk.shard_fwd_occupancy(cuda_device, dims)
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 32, occ
    assert occ["ctas_per_sm"] * occ["threads"] >= 2048, occ
    assert occ["grid"] == -(-139 * 259 // occ["threads"]) \
        * -(-86 // tsk.SHARD_FWD_WALK), occ


@pytest.fixture(scope="module")
def columns_code():
    """The small columns hall's whole weight code (400 Hz, meshed as
    ``_small_columns_hall`` meshes it, no x alignment): walls, columns and
    a bare interior."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from wayverb_tpu_torch.tools.mesh_timing import columns_code
    return columns_code("cuda", cutoff=400.0)


B9_CASES = [("columns hall", None), *B11_CASES[1:]]


@pytest.mark.cuda
@pytest.mark.parametrize("case,cut", B9_CASES, ids=[c for c, _ in B9_CASES])
def test_weighted_step_bwd_kernel_cases(cuda_device, columns_code, case,
                                        cut):
    """B9 to the bit on a real mesh's whole weight code, where bare warps
    meet walls and columns: random g, g at 1e38 with ±inf and NaN, all −0,
    and slices of the hall (Y·Z < 32, X = 1 and 2, odd Y)."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    code = columns_code
    if cut is not None:
        code = code[cut].contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    g = _case_g(case, tuple(code.shape), gen)
    if case == "columns hall":
        assert 0 < int(bare_warps(code).sum()) < bare_warps(code).numel()
    _b9_bit_equal(g, code)


@pytest.mark.cuda
def test_weighted_step_bwd_occupancy(cuda_device):
    """What the card makes of B9: no local memory, at most 32 registers
    (its launch bounds: 2,048 threads an SM), and CTAs of (y, z) nodes each
    walking ``BWD_WALK`` x rows (the wrapper's launch check) cover the
    columns hall."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    dims = (343, 139, 259)
    occ = tsk.bwd_occupancy(cuda_device, dims)
    assert occ["local_bytes"] == 0, occ
    assert 0 < occ["registers"] <= 32, occ
    assert occ["ctas_per_sm"] * occ["threads"] >= 2048, occ
    assert occ["grid"] == -(-139 * 259 // occ["threads"]) \
        * -(-343 // tsk.BWD_WALK), occ


@pytest.mark.cuda
def test_weighted_step_bwd_follows_a_changed_code(cuda_device, columns_code):
    """Each launch of B9 decides its bare warps from the code it is given:
    with a neighbour of weight 2 and one of weight 0 put into two bare
    warps, those warps leave the bare path and B9 equals the plain version
    of the changed code to the bit."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    code = columns_code.clone()
    Z = code.shape[2]
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    g = torch.randn(*code.shape, generator=gen, device="cuda")
    _b9_bit_equal(g, code)
    marked = bare_warps(code).nonzero()
    assert len(marked) > 2
    (x1, s1), (x2, s2) = marked[len(marked) // 3], marked[2 * len(marked) // 3]
    p1, p2 = 32 * int(s1) + 5, 32 * int(s2) + 17
    code[int(x1) - 1, p1 // Z, p1 % Z] |= 1 << 7
    code[int(x2), p2 // Z + 1, p2 % Z] &= ~((1 << 2) | (1 << 8))
    after = bare_warps(code)
    assert not after[x1, s1] and not after[x2, s2]
    _b9_bit_equal(g, code)


@pytest.mark.cuda
def test_general_sharded_gradient_follows_a_changed_code(cuda_device):
    """The sharded gradient follows the weight code of the structure it
    runs: with a run of interior nodes given weight 2 toward +x (another
    weight code, the same boundary tables) it follows the single-device
    gradient of the changed structure, as it follows the original's,
    within 1e-4 of the largest component."""
    from wayverb_tpu_torch.parallel import general_sharded as tgs
    from wayverb_tpu_torch.parallel.sharding import make_device_mesh
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    fs = 400.0 / (0.25 * 0.6)
    mesh = wgrun.compute_mesh(procedural_hall(2, 4, 1)[0],
                              np.full((1, 8), 0.1),
                              grid_spacing(340.0, 1.0 / fs), fs,
                              align=(4, 1, 1), device=cuda_device)
    dims = mesh.descriptor.dimensions
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, (6.4, 4.0, 8.97), (6.9, 4.0, 8.97), 47.5 / fs)
    code = mesh.structure.weight_code.clone()
    sx, rest = divmod(int(source.node_idx), dims[1] * dims[2])
    row = code[sx + 2, rest // dims[2]]     # two rows from the source
    row[row == 0x103F] |= 1 << 7
    changed = dataclasses.replace(mesh.structure, weight_code=code)
    devmesh = make_device_mesh(4, devices=["cuda:0"] * 4)
    grads = []
    for structure in (mesh.structure, changed):
        pair = []
        for run in (lambda s: tgs.run_waveguide_general_sharded(
                        devmesh, s, dims, source, receiver, n),
                    lambda s: wgrun.run_waveguide(s, dims, source, receiver,
                                                  n)):
            coef_b = structure.coef_b.clone().requires_grad_(True)
            out = run(dataclasses.replace(structure, coef_b=coef_b))
            torch.sum(out["outputs"][1] ** 2).backward()
            pair.append(coef_b.grad)
        scale = float(pair[1].abs().max())
        assert scale > 0
        assert float((pair[0] - pair[1]).abs().max()) <= GRAD_REL * scale
        grads.append(pair[0])
    assert not torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_weighted_step_sharded_function_and_checks_on_the_card(cuda_device):
    """The Function's backward launches B11 once; its gradients equal plain
    autograd's through the plain version; what the kernel cannot take
    raises."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    cur, prev, code, halos = _shard_case((3, 10, 33), cuda_device, 6)
    h = torch.randn_like(cur)
    grads = []
    for fn in (tsk.weighted_step_sharded, tsk._weighted_step_sharded_plain):
        leaves = [t.clone().requires_grad_(True)
                  for t in (cur, prev, *halos)]
        before = tsk.weighted_step_sharded_bwd.launches
        torch.sum(fn(leaves[0], leaves[1], code, tuple(leaves[2:])) * h) \
            .backward()
        grads.append(([t.grad for t in leaves],
                      tsk.weighted_step_sharded_bwd.launches - before))
    (got, n_kernel), (want, n_plain) = grads
    assert (n_kernel, n_plain) == (1, 0)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= ATOL
    with pytest.raises(ValueError):
        tsk.weighted_step_sharded(cur, prev, code, (halos[0][:, :5], halos[1]))
    with pytest.raises(ValueError):
        tsk.weighted_step_sharded(cur, prev, code, halos, out=cur)
    with pytest.raises(ValueError):
        tsk.weighted_step_sharded(cur, prev, code, (halos[0].cpu(),
                                                    halos[1]))


@pytest.mark.cuda
def test_general_sharded_on_the_card_equals_single(cuda_device):
    """The small columns hall split into 4 x-shards on one card
    (``["cuda:0"] * 4``): B10 per shard and step, and the outputs equal the
    single-device B8 run's to the bit; its gradient within 1e-4 of the
    largest component, B11 in the backward."""
    from wayverb_tpu_torch.parallel import general_sharded as tgs
    from wayverb_tpu_torch.parallel.sharding import make_device_mesh
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
    fs = 400.0 / (0.25 * 0.6)
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.compute_mesh(procedural_hall(2, 4, 1)[0],
                              np.full((1, 8), 0.1), dx, fs, align=(4, 1, 1),
                              device=cuda_device)
    devmesh = make_device_mesh(4, devices=["cuda:0"] * 4)
    dims = mesh.descriptor.dimensions
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, (6.4, 4.0, 8.97), (6.9, 4.0, 8.97), 63.5 / fs)
    before = tsk.weighted_step_sharded.launches, tsk.weighted_step.launches
    got = tgs.run_waveguide_general_sharded(devmesh, mesh.structure, dims,
                                            source, receiver, n)
    assert (tsk.weighted_step_sharded.launches - before[0],
            tsk.weighted_step.launches - before[1]) == (4 * n, 0)
    want = wgrun.run_waveguide(mesh.structure, dims, source, receiver, n)
    assert bool(got["stable"]) and bool(want["stable"])
    for a, b in zip(got["outputs"], want["outputs"]):
        assert torch.equal(a, b)

    def grad(run):
        coef_b = mesh.structure.coef_b.clone().requires_grad_(True)
        out = run(dataclasses.replace(mesh.structure, coef_b=coef_b))
        torch.sum(out["outputs"][1] ** 2).backward()
        return coef_b.grad

    before = tsk.weighted_step_sharded_bwd.launches
    g_sh = grad(lambda s: tgs.run_waveguide_general_sharded(
        devmesh, s, dims, source, receiver, n))
    # a shard's last steps reach no tap unless it holds the receiver
    assert 0 < tsk.weighted_step_sharded_bwd.launches - before <= 4 * (n - 1)
    g_si = grad(lambda s: wgrun.run_waveguide(s, dims, source, receiver, n))
    scale = float(g_si.abs().max())
    assert scale > 0
    assert float((g_sh - g_si).abs().max()) <= GRAD_REL * scale


# ---------------------------------------------------------------------------
# the ray–triangle kernels (B3, B4)

def _hall_soup(num_triangles):
    """A procedural hall of exactly ``num_triangles`` triangles."""
    from wayverb_tpu_torch.core.geometry import box_scene
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    if num_triangles == 12:
        return box_scene(Box((0.0, 0.0, 0.0), (20.0, 8.0, 15.0)))
    args = {1000: (10, 0, 1), 5448: (20, 6, 3), 20000: (40, 10, 4)}
    soup, n = procedural_hall(*args[num_triangles])
    # trim to the requested count: the kernels need no closed scene
    assert n >= num_triangles
    return dataclasses.replace(soup, triangles=soup.triangles[:num_triangles],
                               surfaces=soup.surfaces[:num_triangles])


def _hall_rays(n, device, seed, num_triangles=None, outside=False):
    gen = torch.Generator().manual_seed(seed)
    size = torch.tensor([20.0, 8.0, 15.0])
    o = (0.05 + 0.9 * torch.rand(n, 3, generator=gen)) * size
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen),
                                      dim=-1)
    if outside:                       # beyond the scene, heading away
        o, d = o + 100.0, d.abs()
    ex = torch.full((n,), -1, dtype=torch.int32) if num_triangles is None \
        else torch.randint(-1, num_triangles, (n,), generator=gen,
                           dtype=torch.int32)
    return o.to(device), d.to(device), ex.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rays", [100, 512, 4096])
@pytest.mark.parametrize("num_triangles,cull", [
    (12, False), (1000, False), (5448, False), (20000, False),
    (12, True), (1000, True), (20000, True)])
def test_mt_closest_kernels_match_plain(cuda_device, rays, num_triangles,
                                        cull):
    """B3 (all pairs) and B4 (culled) against their plain versions on the
    same CUDA tensors, to the bit: with and without excludes, and rays that
    all miss."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    tris = mk.build_mt_triangles(_hall_soup(num_triangles),
                                 cull=cull).to(cuda_device)
    plain = mk._closest_culled_plain if cull else mk._closest_plain
    for case in ("no excludes", "excludes", "all miss"):
        o, d, ex = _hall_rays(
            rays, cuda_device, seed=rays + num_triangles,
            num_triangles=num_triangles if case == "excludes" else None,
            outside=case == "all miss")
        if cull:
            order = torch.argsort(mk._ray_sort_keys(o, d, tris), stable=True)
            o, d, ex = (x[order].contiguous() for x in (o, d, ex))
        before = (mk.mt_closest.launches, mk.mt_closest.culled_launches)
        t, i = mk.mt_closest(o, d, ex, tris)
        torch.cuda.synchronize()
        after = (mk.mt_closest.launches, mk.mt_closest.culled_launches)
        assert after == (before[0] + (not cull), before[1] + cull)
        t_want, i_want = plain(o, d, ex, tris)
        assert torch.equal(t, t_want), (case, float((t - t_want).abs().max()))
        assert torch.equal(i, i_want), case
        hits = float((t < mk.BIG).float().mean())
        # (a trimmed hall is not closed: some rays leave through the gap)
        assert hits == 0.0 if case == "all miss" else hits > 0.5, (case, hits)


@pytest.mark.cuda
def test_mt_kernels_lowest_id_wins_and_no_gradient(cuda_device):
    """A triangle list repeated three times (equal t in two triangle tiles):
    the lowest id wins, then the next copy once that is excluded;
    ``mt_closest`` refuses an input that requires grad and tensors it cannot
    take."""
    from wayverb_tpu_torch.core.geometry import TriangleSoup
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    soup = _hall_soup(1000)
    dup = TriangleSoup(soup.vertices, torch.cat([soup.triangles] * 3),
                       torch.cat([soup.surfaces] * 3))
    o, d, ex = _hall_rays(700, cuda_device, seed=3)
    for cull in (False, True):
        tris = mk.build_mt_triangles(dup, cull=cull).to(cuda_device)
        t, i, hit = mk.mt_intersection(o, d, tris)
        assert bool(hit.any()) and int(i[hit].max()) < 1000
        t1, i1, hit1 = mk.mt_intersection(o, d, tris, exclude_triangle=i)
        assert torch.equal(hit1, hit) and torch.equal(t1[hit], t[hit])
        assert torch.equal(i1[hit], i[hit] + 1000)
    with pytest.raises(ValueError, match="no gradient"):
        mk.mt_closest(o.clone().requires_grad_(True), d, ex, tris)
    with pytest.raises(ValueError, match="exclude"):
        mk.mt_closest(o, d, ex.long(), tris)
    with pytest.raises(ValueError, match="origin"):
        mk.mt_closest(o.cpu().to(torch.float64).to(cuda_device), d, ex, tris)
    with pytest.raises(ValueError, match="packed"):
        mk.mt_closest(o, d, ex, mk.build_mt_triangles(dup))   # on the CPU


@pytest.mark.cuda
def test_auto_accel_on_the_card(cuda_device):
    from wayverb_tpu_torch.raytracer import accel, mt_kernels as mk
    assert accel.auto_accel(_hall_soup(12), cuda_device) is None
    small = accel.auto_accel(_hall_soup(1000), "cuda")
    assert isinstance(small, mk.MtTriangles) and not small.culled
    assert small.packed.is_cuda and small.packed.shape == (9, 1024)
    large = accel.auto_accel(_hall_soup(20000), cuda_device)
    assert large.culled and large.tile_boxes.is_cuda
    assert large.tile_boxes.shape == (20, 8)
    assert isinstance(accel.auto_accel(_hall_soup(1000), "cpu"),
                      accel.RayGrid)


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True])
def test_trace_on_the_card_matches_dda_on_cpu(cuda_device, cull):
    """``trace`` on a small hall: the MT kernels on the card against the
    voxel DDA on the CPU, same draws.  Hit histories equal on ≥ 99.5 % of
    entries (a hit on a shared edge may take either triangle), per-band
    histogram totals within 1e-3."""
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer import accel, mt_kernels as mk, tracer
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    soup = procedural_hall(8, 2, 2)[0]
    surfaces = Surface(torch.full((1, 8), 0.1), torch.full((1, 8), 0.1))
    src, rcv = (2.0, 1.7, 3.0), (6.0, 1.9, 9.0)
    kwargs = dict(num_rays=2048, depth=8, max_time=0.4)
    cpu = tracer.trace(soup, surfaces, src, rcv,
                       torch.Generator().manual_seed(4),
                       accel=accel.build_ray_grid(soup), **kwargs)
    before = (mk.mt_closest.launches, mk.mt_closest.culled_launches)
    card = tracer.trace(
        soup.to(cuda_device), surfaces.to(cuda_device), src, rcv,
        torch.Generator().manual_seed(4),
        accel=mk.build_mt_triangles(soup, cull=cull).to(cuda_device),
        **kwargs)
    after = (mk.mt_closest.launches, mk.mt_closest.culled_launches)
    # two launches a bounce: the closest hit, then the receiver's visibility
    assert after[cull] - before[cull] == 16
    assert after[not cull] == before[not cull]
    agree = (card.triangle_history.cpu() == cpu.triangle_history) \
        .float().mean()
    assert float(agree) >= 0.995, float(agree)
    g = card.histogram.cpu().sum(dim=(0, 1, 2))
    w = cpu.histogram.sum(dim=(0, 1, 2))
    assert float(w.min()) > 0
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3)


# ---------------------------------------------------------------------------
# B4 spread over a thread-block cluster of mt_kernels.CLUSTER CTAs

B4_CASES = SCENES + ("hall of 20,000, 1000 rays", "hall of 20,000, 300 rays",
                     "hall of 20,000, a quarter of the origins not finite")


def _b4_case(case, device):
    """(culled tables, origin, direction, exclude) on ``device``, the rays
    sorted for the gate: the CPU file's scenes (ties between the cluster's
    shares, a hit found only through a vote) or the trimmed hall."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    if case in SCENES:
        tris, o, d, ex = _scene(case)
        return (tris.to(device), *(x.to(device) for x in (o, d, ex)))
    tris = mk.build_mt_triangles(_hall_soup(20000), cull=True).to(device)
    rays = 300 if "300" in case else (4096 if "finite" in case else 1000)
    o, d, ex = _hall_rays(rays, device, seed=rays, num_triangles=20000)
    if "finite" in case:
        o[0::8] = float("nan")
        o[1::8, 0] = float("inf")
    order = torch.argsort(mk._ray_sort_keys(o, d, tris), stable=True)
    return (tris, *(x[order].contiguous() for x in (o, d, ex)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", B4_CASES)
def test_b4_cluster_matches_plain(cuda_device, case):
    """B4 against ``_closest_culled_plain`` to the bit: ragged ray counts,
    rays below one gate tile, dead rays, equal t in two CTAs' shares (the
    lowest id wins), a slack hit that only the gate tile's one voter lets
    through."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    tris, o, d, ex = _b4_case(case, cuda_device)
    before = mk.mt_closest.culled_launches
    t, i = mk.mt_closest(o, d, ex, tris)
    torch.cuda.synchronize()
    assert mk.mt_closest.culled_launches == before + 1
    t_want, i_want = mk._closest_culled_plain(o, d, ex, tris)
    assert torch.equal(t, t_want), (case, float((t - t_want).abs().max()))
    assert torch.equal(i, i_want), case
    if case == "ties":
        assert torch.equal(i.cpu(), torch.where(ex.cpu() == 127, 128, 127)
                           .to(torch.int32))


@pytest.mark.cuda
def test_b4_cluster_residency(cuda_device):
    """The kernel spills nothing, two CTAs of 512 threads fit an SM, and the
    card holds clusters of ``CLUSTER`` CTAs."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    occ = mk.culled_occupancy(cuda_device)
    assert occ["local_bytes"] == 0 and occ["ctas_per_sm"] >= 2, occ
    assert occ["clusters"] >= 1 and occ["registers"] <= 64, occ


# ---------------------------------------------------------------------------
# B3: the triangle axis split over a thread-block cluster of B3_CLUSTER CTAs

B3_CASES = B3_SCENES + ("the model hall's bounce-2 query, 8192 rays",)


def _b3_case(case, device):
    """(all-pairs table, origin, direction, exclude) on ``device``: the CPU
    file's scenes (ragged and short ray counts, dead rays, equal t in
    several shares, an exclude in another share, fewer triangles than
    shares, slack edges) or the rays a trace gives B3."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    from wayverb_tpu_torch.tools import rays_timing as rt
    if case in B3_SCENES:
        tris, o, d, ex = _b3_scene(case)
        return (tris.to(device), *(x.to(device) for x in (o, d, ex)))
    soup = procedural_hall()[0].to(device)
    tris = mk.build_mt_triangles(soup, cull=False).to(device)
    return (tris, *rt.record_queries(soup, tris, rt.MODEL_SRC, rt.MODEL_RCV,
                                     {4}, num_rays=8192)[4])


@pytest.mark.cuda
@pytest.mark.parametrize("case", B3_CASES)
def test_b3_split_matches_plain(cuda_device, case):
    """B3 against ``_closest_plain`` to the bit: R below one block (100,
    700) and ragged over two (1500), dead rays, equal t in several CTAs'
    shares (the lowest id wins), an exclude in another CTA's share, 3 and 12
    triangles, rays on the slack's edges, and a trace's query."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    tris, o, d, ex = _b3_case(case, cuda_device)
    before = mk.mt_closest.launches
    t, i = mk.mt_closest(o, d, ex, tris)
    torch.cuda.synchronize()
    assert mk.mt_closest.launches == before + 1
    t_want, i_want = mk._closest_plain(o, d, ex, tris)
    assert torch.equal(t, t_want), (case, float((t - t_want).abs().max()))
    assert torch.equal(i, i_want), case
    assert float((t < mk.BIG).float().mean()) > 0.0, case


@pytest.mark.cuda
def test_b3_residency(cuda_device):
    """B3 spills nothing and keeps to 64 registers, so that the register
    file holds its CTA of 32 warps on every SM, and the card holds at once
    the 64 clusters that 65,536 rays make: one wave."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    occ = mk.closest_occupancy(cuda_device)
    assert occ["local_bytes"] == 0 and occ["registers"] <= 64, occ
    assert occ["ctas_per_sm"] == 1, occ
    assert occ["clusters"] >= 64, occ


# ---------------------------------------------------------------------------
# the residency probe (P1)

PROBE_CASES = [  # (dims, K, resident, tile): tile None is plan_tiles' choice
    ((12, 9, 7), 5, True, None), ((12, 9, 7), 5, False, None),
    ((12, 9, 7), 6, True, (5, 4, 3)), ((9, 10, 8), 1, True, (3, 3, 8)),
    ((15, 19, 21), 7, True, None), ((15, 19, 21), 7, False, None),
    ((64, 224, 256), 4, True, None), ((64, 224, 256), 3, False, None),
    # a cooperative grid of clusters: the worked placement, even and odd K
    ((64, 224, 256), 3, True, None), ((64, 224, 256), 1, True, None),
    ((32, 224, 256), 5, True, None),
    # one cluster: the T30 box, (12, 9, 7) at K = 1 and 5, one CTA
    ((15, 19, 21), 1, True, None), ((15, 19, 21), 2, True, (2, 19, 21)),
    ((12, 9, 7), 1, True, None), ((12, 9, 7), 2, True, (12, 9, 7)),
    # given tiles cut on each axis, clusters of 12, 8, 4 and 2
    ((24, 10, 40), 5, True, (2, 5, 20)), ((24, 10, 40), 4, True, (1, 10, 40)),
    ((24, 10, 40), 3, True, (1, 5, 20)), ((16, 12, 40), 4, True, (4, 6, 20)),
    ((64, 224, 256), 5, True, (8, 28, 128)),
    # device memory above the 50 MB L2
    ((128, 224, 256), 3, False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,K,resident,tile", PROBE_CASES)
def test_probe_resident_kernel_matches_plain(cuda_device, dims, K, resident,
                                             tile):
    """P1 in both modes against ``chunk_plain`` on the same tensors, to the
    bit: X % 8 != 0, odd (Y, Z), odd K, tiles cut in x, y and z, grids on
    one cluster (the T30 box's among them) and on a cooperative grid of
    clusters (the worked placement (64, 224, 256)), device memory."""
    from wayverb_tpu_torch.tools import probe_resident as pr
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    cur = torch.randn(dims, generator=gen, device=cuda_device)
    prev = torch.randn(dims, generator=gen, device=cuda_device)
    keep = cur.clone(), prev.clone()
    before = pr.resident_chunk.launches
    got = pr.resident_chunk(cur, prev, K, resident=resident, tile=tile)
    assert pr.resident_chunk.launches == before + 1
    want = pr.chunk_plain(cur, prev, K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) == 0.0
    assert torch.equal(cur, keep[0]) and torch.equal(prev, keep[1])


@pytest.mark.cuda
def test_probe_resident_unplaceable_raises_before_launch(cuda_device):
    from wayverb_tpu_torch.tools import probe_resident as pr
    cap = pr.resident_capacity(cuda_device)
    assert cap.sms >= 1 and cap.smem_per_cta > 48 * 1024 \
        and cap.l2_bytes > 0
    cur = torch.zeros((96, 224, 256), device=cuda_device)
    before = pr.resident_chunk.launches
    with pytest.raises(ValueError, match=str(8 * cur.numel())):
        pr.resident_chunk(cur, cur.clone(), 2)
    with pytest.raises(ValueError):
        pr.resident_chunk(cur[:8], cur[:8].clone(), 2, tile=(8, 224, 256))
    wide = torch.zeros((64, 238, 256), device=cuda_device)  # 136 tiles
    with pytest.raises(ValueError):
        pr.resident_chunk(wide, wide.clone(), 2, tile=(8, 14, 256))
    assert pr.resident_chunk.launches == before
    value = pr.make_run(15, 19, 21, 8, "cuda")(
        *pr.impulse_fields((15, 19, 21), cuda_device), 2)
    assert value.is_cuda and bool(torch.isfinite(value))
    assert pr.resident_chunk.launches == before + 2


@pytest.mark.cuda
def test_probe_resident_occupancy(cuda_device):
    """P1's launches on the card: the worked placement in clusters of 2,
    each resident at once, at most 64 registers and no local memory; the
    T30 box on one cluster; device memory on its persistent grid."""
    from wayverb_tpu_torch.tools import probe_resident as pr
    cap = pr.resident_capacity(cuda_device)
    assert dict(cap.clusters)[2] >= 64 and cap.clusters_at_once(1) == cap.sms
    occ = pr.occupancy((64, 224, 256), True, cuda_device)
    assert (occ["form"], occ["cluster"], occ["tiles"]) == ("grid", 2, 128)
    assert occ["registers"] <= 64 and occ["local_bytes"] == 0, occ
    assert occ["ctas_per_sm"] >= 1 and occ["clusters"] >= 64, occ
    occ = pr.occupancy((15, 19, 21), True, cuda_device)
    assert occ["form"] == "one cluster" and occ["clusters"] >= 1, occ
    assert occ["local_bytes"] == 0, occ
    occ = pr.occupancy((128, 224, 256), False, cuda_device)
    assert occ["form"] == "device memory" and occ["local_bytes"] == 0, occ
    assert occ["index_bits"] == 32, occ
    # the launch's persistent grid is resident at once
    cur = torch.zeros((128, 224, 256), device=cuda_device)
    pr.resident_chunk(cur, cur, 2, resident=False)
    grid = pr.resident_chunk.last_grid
    assert 1 <= grid["ctas"] <= occ["ctas_per_sm"] * cap.sms, grid
    assert grid["threads"] == pr.STREAM_THREADS, grid


@pytest.mark.cuda
def test_probe_resident_device_memory_past_2_31_nodes(cuda_device):
    """The device-memory form takes a 64-bit node index from 2^31 nodes on:
    such a grid (8.6 GB a field) runs, without spills, its last planes to
    the bit against ``chunk_plain`` of the planes they read."""
    from wayverb_tpu_torch.tools import probe_resident as pr
    dims = (2 ** 31 // (224 * 256) + 1, 224, 256)
    occ = pr.occupancy(dims, False, cuda_device)
    assert occ["index_bits"] == 64 and occ["local_bytes"] == 0, occ
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    cur = torch.zeros(dims, device=cuda_device)
    prev = torch.zeros(dims, device=cuda_device)
    cur[-3:] = torch.randn((3,) + dims[1:], generator=gen, device=cuda_device)
    prev[-3:] = torch.randn((3,) + dims[1:], generator=gen,
                            device=cuda_device)
    assert cur.numel() >= 2 ** 31
    new, old = pr.resident_chunk(cur, prev, 1, resident=False)
    assert pr.resident_chunk.last_grid["ctas"] <= \
        occ["ctas_per_sm"] * pr.resident_capacity(cuda_device).sms
    want = pr.chunk_plain(cur[-3:], prev[-3:], 1)
    torch.cuda.synchronize()
    assert torch.equal(new[-2:], want[0][-2:])
    assert torch.equal(old[-2:], cur[-2:])
    del cur, prev, new, old
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_probe_step0_launches_are_accepted(cuda_device):
    """Step 0 on the card: every barrier launch accepted, the cooperative
    grids of clusters among them, at the clusters ``resident_capacity``
    reads (the H100 SXM's are ``H100_CLUSTERS``)."""
    from wayverb_tpu_torch.tools import probe_resident as pr
    cap = pr.resident_capacity(cuda_device)
    out = pr.step0(cuda_device, n=20)
    assert out["smem_per_cta"] == cap.smem_per_cta
    assert out["clusters_resident"] == {
        c: cap.clusters_at_once(c) for c in pr.CLUSTER_SIZES}
    assert all(isinstance(b["us"], float) for b in out["barriers"]), out
    assert any(b["cooperative"] and b["cluster"] > 1
               for b in out["barriers"]), out
    if (cap.sms, cap.smem_per_cta) == (132, 232448):
        assert cap.clusters == pr.H100_CLUSTERS


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["box", "regions", "general"])
def test_run_chunk_on_the_card_equals_continuous(cuda_device, route):
    """``checkpoint.run_chunk`` on the card, 90 steps in uneven chunks, to
    the bit against one continuous run of the route's ``run_*`` function:
    the fused step (B1), the masked interior step (B12) or the weighted
    step (B8), one launch a step either way; a save and load in the middle
    resumes to the bit."""
    import tempfile

    from wayverb_tpu_torch.waveguide import checkpoint as ck
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    from wayverb_tpu_torch.waveguide.receivers import \
        make_directional_receiver
    from wayverb_tpu_torch.waveguide.sources import (HardSource,
                                                     impulse_signal)
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.shoebox_mesh(Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8)),
                              np.full((1, 8), 0.1), dx, fs,
                              device=cuda_device)
    if route != "box":
        mesh = dataclasses.replace(mesh, box_spec=None)
    if route == "general":
        mesh = dataclasses.replace(mesh, regions=None)
    desc = mesh.descriptor
    steps = 90
    source = HardSource(node_idx=desc.flat_index(mesh.require_inside(
        (0.7, 0.8, 0.5))), signal=impulse_signal(steps, 1.0, cuda_device))
    receiver = make_directional_receiver(
        desc, fs, 1.225, desc.position(mesh.require_inside((0.7, 0.8, 1.3))),
        cuda_device)
    counter = {"box": tbf.fused_step, "regions": sk.interior_step,
               "general": sk.weighted_step}[route]
    dims = desc.dimensions
    if route == "box":
        want = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                       receiver, steps)
    elif route == "regions":
        want = wgrun.run_waveguide_regions(mesh.structure, dims, source,
                                           receiver, steps, mesh.regions)
    else:
        want = wgrun.run_waveguide(mesh.structure, dims, source, receiver,
                                   steps)
    before = counter.launches
    state = ck.initial_state(mesh, receiver)
    pieces = []
    with tempfile.TemporaryDirectory() as tmp:
        for chunk in (1, 40, 49):
            state, out = ck.run_chunk(mesh, source, receiver, state, chunk)
            pieces.append(out)
            if state.step == 41:
                ck.save_state(f"{tmp}/s.npz", state)
                state = ck.load_state(f"{tmp}/s.npz", mesh, receiver)
    torch.cuda.synchronize()
    assert counter.launches - before == steps
    assert state.current.is_cuda and bool(state.stable)
    got = tuple(torch.cat(p) for p in zip(*pieces))
    for g, w in zip(got, want["outputs"]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_trace_on_the_card_equals_cpu(cuda_device):
    """``trace`` on the card against the CPU with the same directions, 272
    bounces at absorption 0.05 on the test_combined box: every ray keeps
    one triangle history and its reflection points to the bit (the ray
    leg's arithmetic is the same on both devices), and the histograms,
    summed by ``index_add_`` in another order on the card, agree within
    1e-6 of their energy in L1."""
    from wayverb_tpu_torch.core.geometry import box_scene
    from wayverb_tpu_torch.core.orientation import random_unit_vectors
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer import tracer
    soup = box_scene(Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81)))
    surfaces = Surface(
        absorption=torch.tensor([[0.4, 0.2, 0.1] + [0.05] * 5]),
        scattering=torch.full((1, 8), 0.1))
    rays, depth = 2048, 272
    gen = torch.Generator().manual_seed(11)
    directions = (random_unit_vectors(rays, gen),
                  torch.stack([random_unit_vectors(rays, gen)
                               for _ in range(depth)]))
    runs = [tracer.trace(soup.to(device), surfaces.to(device),
                         (2.09, 2.12, 2.12), (2.09, 3.08, 0.96), None,
                         num_rays=rays, depth=depth, max_time=1.5,
                         max_image_source_order=4, directions=directions,
                         capture_positions=True)
            for device in (cuda_device, "cpu")]
    card, cpu = runs
    assert torch.equal(card.triangle_history.cpu(), cpu.triangle_history)
    assert torch.equal(card.positions.cpu(), cpu.positions)
    total = float(cpu.histogram.sum())
    assert float((card.histogram.cpu() - cpu.histogram).abs().sum()) <= \
        1e-6 * total


@pytest.mark.cuda
def test_image_sources_on_the_card_equal_cpu(cuda_device):
    """The image sources of phase 37's box (test_combined's, 8192 rays to
    order 4, one CPU trace's triangle history): the tree, its validation,
    the direct impulse and four capsules' ``attenuate`` give the same bits
    on the card as on the CPU (``core.geometry``'s three-vector ops).  The
    head IR is within 1e-6 of its peak, not equal, and the test shows why:
    on the same bit-equal inputs the sinc deposit (its elementwise ``cos``
    and ``sinc``, which the two devices round differently) and the
    multiband mixdown (cuFFT against the CPU's FFT) each part by a few
    1e-7 of peak, the deposit also with its sum made on the host, so the
    gap is not the card's atomic adds."""
    from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
    from wayverb_tpu_torch.core.geometry import box_scene
    from wayverb_tpu_torch.core.orientation import (Orientation,
                                                    random_unit_vectors)
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.imagesource import exact, tree
    from wayverb_tpu_torch.imagesource import postprocess as ipp
    from wayverb_tpu_torch.raytracer import histogram, tracer
    from wayverb_tpu_torch.signal.multiband import \
        multiband_filter_and_mixdown
    soup = box_scene(Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81)))
    surfaces = Surface(
        absorption=torch.tensor([[0.4, 0.2, 0.1] + [0.05] * 5]),
        scattering=torch.full((1, 8), 0.1))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    gen = torch.Generator().manual_seed(37)
    # image sources of order 4 come from the histories' first four
    # bounces: eight bounces find the paths the engine's 272 find
    rays, depth = 8192, 8
    directions = (random_unit_vectors(rays, gen),
                  torch.stack([random_unit_vectors(rays, gen)
                               for _ in range(depth)]))
    history = tracer.trace(soup, surfaces, src, rcv, None, num_rays=rays,
                           depth=depth, max_time=1.5,
                           max_image_source_order=4,
                           directions=directions).triangle_history
    methods = (Null(), Microphone(Orientation((0.3, 0.2, 0.9)), 0.5),
               Hrtf(channel=0), Hrtf(channel=1))

    def impulses(device):
        return tree.find_image_source_impulses(
            history, soup.to(device), surfaces.to(device), src, rcv,
            max_order=4).concatenate(exact.get_direct(src, rcv,
                                                      soup.to(device)))

    def bits(t):
        return t.cpu().view(torch.int32)

    def rel(got, want):
        return float((got.cpu() - want).abs().max()) \
            / float(want.abs().max())

    card, cpu = impulses(cuda_device), impulses("cpu")
    assert cpu.volume.shape[0] > 1
    for name in ("volume", "position", "distance"):
        assert torch.equal(bits(getattr(card, name)),
                           bits(getattr(cpu, name))), name
    for method in methods:
        for got, want in zip(ipp.attenuate(method, rcv, card),
                             ipp.attenuate(method, rcv, cpu)):
            assert torch.equal(bits(got), bits(want)), method
        want = ipp.postprocess(cpu, method, rcv, 340.0, 16000.0)
        head = ipp.postprocess(card, method, rcv, 340.0, 16000.0)
        assert head.shape == want.shape
        assert rel(head, want) <= 1e-6, method

    volumes, distances = ipp.attenuate(Null(), rcv, cpu)
    times = distances / torch.full_like(distances, 340.0)
    bins = int(float(times.max()) * 16000.0) + 1
    hist = histogram.sinc_histogram(times, volumes, 16000.0, bins)
    deposit = rel(histogram.sinc_histogram(
        times.to(cuda_device), volumes.to(cuda_device), 16000.0, bins),
        hist)
    scattered = histogram.scatter_add_drop
    histogram.scatter_add_drop = lambda n, idx, values: scattered(
        n, idx.cpu(), values.cpu()).to(values.device)
    try:
        host_sum = rel(histogram.sinc_histogram(
            times.to(cuda_device), volumes.to(cuda_device), 16000.0, bins),
            hist)
    finally:
        histogram.scatter_add_drop = scattered
    mixdown = rel(multiband_filter_and_mixdown(hist.T.to(cuda_device),
                                               16000.0),
                  multiband_filter_and_mixdown(hist.T, 16000.0))
    # the deposit parts with its sum made on the host too: its weights do
    assert deposit <= 1e-6 and 0.0 < host_sum <= 1e-6
    assert 0.0 < mixdown <= 1e-6
