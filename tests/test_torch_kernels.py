"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU mode)
and skips without CUDA.  The file imports neither JAX nor the reference
package, so it runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from wayverb_tpu_torch.core.geometry import Box
from wayverb_tpu_torch.waveguide import box_fused as tbf
from wayverb_tpu_torch.waveguide import box_mega as tbm
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

ATOL = 1e-5          # the bound tests/test_box_fused.py holds Pallas to
MEGA_REL = 1e-5      # B2 against its plain version, per unit of peak


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random_step(dims, device, seed=0):
    inside = np.zeros(dims, dtype=bool)
    inside[2:-2, 2:-2, 2:-2] = True
    spec = tbf.spec_from_inside(inside)
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device=device)
    return spec, (rnd(*dims), rnd(*dims),
                  tuple(rnd(*s) for s in tbf._plane_shapes(*dims)), rnd(2),
                  (rnd(1, *dims[1:]), rnd(1, *dims[1:])))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,src,mode", [
    ((16, 16, 128), (8, 9, 64), 0), ((16, 16, 128), (8, 9, 64), 1),
    ((16, 16, 128), (2, 4, 64), 2), ((37, 29, 53), (18, 14, 26), 2)])
def test_fused_step_kernel_matches_plain(cuda_device, dims, src, mode):
    spec, (cur, prev, planes, inj_val, halos) = _random_step(dims,
                                                            cuda_device)
    args = (spec.geom_array(), cur, prev, planes, src + (mode,), inj_val,
            halos)
    before = tbf.fused_step.launches
    got_next, got_inner = tbf.fused_step(*args)
    assert tbf.fused_step.launches == before + 1
    want_next, want_inner = tbf._fused_step_plain(*args)
    torch.cuda.synchronize()
    assert float((got_next - want_next).abs().max()) <= ATOL
    for g, w in zip(got_inner, want_inner):
        assert float((g - w).abs().max()) <= ATOL


@pytest.mark.cuda
def test_fused_step_kernel_rejects_what_it_cannot_take(cuda_device):
    spec, (cur, prev, planes, _, _) = _random_step((16, 16, 128),
                                                   cuda_device)
    geom = spec.geom_array()
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur.double(), prev.double(), planes)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur.transpose(1, 2).contiguous().transpose(1, 2),
                       prev, planes)
    with pytest.raises(ValueError):
        tbf.fused_step(geom, cur, prev, planes, out=cur)
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
