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
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

ATOL = 1e-5          # the bound tests/test_box_fused.py holds Pallas to


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
    case, bound 1e-5 per unit of peak; one kernel launch per step."""
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
    outs = []
    for device in (cuda_device, "cpu"):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                                  device=device)
        before = tbf.fused_step.launches
        outs.append(wgrun.canonical(mesh, (0.7, 0.8, 0.6), (0.7, 0.8, 1.3),
                                    0.09))
        launched = tbf.fused_step.launches - before
        assert launched == (300 if device == cuda_device else 0)
    card, cpu = outs
    assert bool(card.stable) and bool(cpu.stable)
    peak = float(cpu.pressure.abs().max())
    assert float((card.pressure.cpu() - cpu.pressure).abs().max()) <= \
        ATOL * max(1.0, peak)
    assert float((card.intensity.cpu() - cpu.intensity).abs().max()) <= ATOL
