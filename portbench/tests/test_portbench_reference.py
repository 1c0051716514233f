"""The plain reference against the port's CPU routes on small rooms, and
its set-up against the port's at the cells' real sizes."""

import numpy as np
import pytest
import torch

from portbench.harness import generator, manifest, scenes
from portbench.reference import filters
from portbench.reference import waveguide as ref
from portbench.tests import small


def _reference_render(cfg, src, rcv, steps):
    env = cfg["environment"]
    fs = generator.mesh_rate(cfg)
    shell, cols = scenes.boxes(cfg)
    room = ref.build_room(shell, cols, cfg["absorption"], fs,
                          env["speed_of_sound"], "cpu")
    sig = torch.as_tensor(generator.impulse(cfg, room.grid.spacing, steps))
    taps, stable = ref.run(room, src, rcv, sig, steps)
    p, i = ref.directional(taps.numpy(), room.grid.spacing, room.sample_rate,
                           env["acoustic_impedance"] / env["speed_of_sound"])
    return room, p, i, stable


@pytest.mark.parametrize("which", ["shoebox", "columns"])
def test_reference_matches_the_port_on_a_small_room(which):
    from wayverb_tpu_torch.waveguide import run as wgrun
    cfg = getattr(small, which)()
    fs = generator.mesh_rate(cfg)
    mesh = scenes.program_mesh(cfg, fs, "cpu", {})
    src, rcv = next(generator.positions(cfg, small.traffic("wg"), 11))
    steps = 200
    room, p, i, stable = _reference_render(cfg, src, rcv, steps)
    assert room.grid.dims == tuple(mesh.descriptor.dimensions)
    inside = mesh.inside
    assert np.array_equal(
        ref.inside_mask(room.grid, *scenes.boxes(cfg), "cpu").numpy(), inside)
    out = wgrun.canonical(mesh, src, rcv, (steps - 0.5) / room.sample_rate)
    assert stable and bool(out.stable)
    gap = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    assert gap(out.pressure.numpy(), p) < 5e-4
    assert gap(out.intensity.numpy(), i) < 5e-4


def test_reference_matches_the_port_in_float64():
    """In float64 the two agree to rounding: the same equations."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    cfg = small.shoebox()
    fs = generator.mesh_rate(cfg)
    mesh = scenes.program_mesh(cfg, fs, "cpu", {})
    src, rcv = next(generator.positions(cfg, small.traffic("wg"), 5))
    shell, _ = scenes.boxes(cfg)
    room = ref.build_room(shell, [], cfg["absorption"], fs, 340.0, "cpu")
    steps = 120
    sig = torch.as_tensor(generator.impulse(cfg, room.grid.spacing, steps))
    taps, _ = ref.run(room, src, rcv, sig.double(), steps,
                      dtype=torch.float64)
    out = wgrun.canonical(mesh, src, rcv, (steps - 0.5) / room.sample_rate,
                          dtype=torch.float64)
    p = taps[:, 0].numpy()
    assert np.abs(out.pressure.numpy() - p).max() <= 1e-10 * np.abs(p).max()


def test_filters_equal_the_ports_fit():
    from wayverb_tpu_torch.waveguide import boundary as bdry
    for absorption, fs in ((np.full(8, 0.1), 3333.3333333333335),
                           (np.linspace(0.05, 0.6, 8), 10000.0)):
        got = filters.coefficient_tables([absorption], fs)
        want = bdry.coefficient_table(
            [bdry.compute_boundary_coefficients(absorption, fs)])
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name,dims", [("shoebox_hall", (224, 224, 256)),
                                       ("columns_hall", (231, 95, 173))])
def test_grids_of_the_cells(name, dims):
    """The reference's grid is the port's at the real sizes."""
    from wayverb_tpu_torch.core.geometry import Box, scene_aabb
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_adjusted_boundary, descriptor_for_box)
    cfg = manifest.config(name)
    env = cfg["environment"]
    fs = generator.mesh_rate(cfg)
    spacing = ref.grid_spacing(env["speed_of_sound"], fs)
    shell, cols = scenes.boxes(cfg)
    grid = ref.make_grid(shell[0], shell[1], spacing)
    if cols:
        from wayverb_tpu_torch.core.geometry import TriangleSoup
        v, t = scenes.soup_arrays(cfg)
        aabb = scene_aabb(TriangleSoup(torch.as_tensor(v),
                                       torch.as_tensor(t),
                                       torch.zeros(len(t), dtype=torch.int32)))
    else:
        aabb = Box(*shell)
    desc = descriptor_for_box(compute_adjusted_boundary(
        aabb, tuple(np.asarray(aabb.centre())), spacing), spacing)
    assert grid.dims == tuple(desc.dimensions) == dims
    assert np.array_equal(grid.min_corner, np.asarray(desc.min_corner))


def test_columns_hall_is_procedural_hall():
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    v, t = scenes.soup_arrays(manifest.config("columns_hall"))
    soup, n = procedural_hall(2, 4, 1)
    assert n == len(t) == 96
    assert np.array_equal(v, soup.vertices.numpy())
    assert np.array_equal(t, soup.triangles.numpy())


def test_reference_gradients_match_the_port():
    """The fit's first gradients: the reference's autograd through
    checkpointed segments against the port's mega route on the CPU."""
    from portbench.harness import manifest as mf
    fit = mf.module("kinds", "fit")
    inp = fit.inputs(small.shoebox(), small.traffic("fit"), 3)
    cell = fit.Cell(torch, inp, "cpu")
    held = cell.hand_over(3)
    ref = fit.reference_fit(torch, inp, "cpu", segment=32)
    numbers = fit.compare(torch, held, ref, inp.signal0)
    assert numbers["loss_gap"] < 1e-3
    assert numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 1e-3
    for a, b in zip(held["grads0"], ref["grads0"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
