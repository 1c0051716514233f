"""The port's waveguide leg end to end against the JAX reference, on the CPU.

``canonical`` runs on the 1.4×1.6×1.8 m box of ``__graft_entry__.py`` for
about 300 steps.  The port's mesh is carried across from the JAX mesh with
``convert.mesh_from_numpy``, so both packages run on the same coefficient
tables.  Also here: the float64 filter state, the kernel-injection
semantics, the routing of a mesh that is no box and the package's
independence from JAX.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core.geometry import Box as JBox
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core.geometry import Box as TBox
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide.box_fused import initial_box_carry
from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
from wayverb_tpu_torch.waveguide.sources import (HardSource, SoftSource,
                                                 impulse_signal)

torch.set_num_threads(2)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)
BOX = ((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
SRC, RCV = (0.7, 0.8, 0.6), (0.7, 0.8, 1.3)
SIM_TIME = 0.09          # 300 steps at FS
ATOL = 2e-5              # receiver-output bound of tests/test_box_mega.py
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_mesh():
    return j_run.shoebox_mesh(JBox(*BOX), np.full((1, 8), 0.1), DX, FS)


def _port_mesh(jm):
    """The port's Mesh from the JAX mesh's fields, as numpy arrays."""
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


_NO_FMA_REFERENCE = f"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from wayverb_tpu.core.geometry import Box
from wayverb_tpu.waveguide import run
out = run.canonical(run.shoebox_mesh(Box(*{BOX!r}), np.full((1, 8), 0.1),
                                     {DX!r}, {FS!r}),
                    {SRC!r}, {RCV!r}, {SIM_TIME!r})
np.savez(sys.argv[1], pressure=out.pressure, intensity=out.intensity,
         stable=out.stable, sample_rate=out.sample_rate)
"""


def _jax_reference(jax_mesh, case, tmp_path):
    """The JAX ``canonical`` outputs, run jitted.

    ``float32_no_fma`` runs the reference in a child process whose XLA
    compiles for AVX, a target without FMA: XLA's CPU backend otherwise
    always contracts a·b + c into one FMA, which rounds the plane update's
    last bit differently from torch's separate multiply and add.
    """
    if case == "float32_no_fma":
        path = tmp_path / "reference.npz"
        env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_cpu_max_isa=AVX").strip())
        proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                               str(path)], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        ref = np.load(path)
        return (ref["pressure"], ref["intensity"], bool(ref["stable"]),
                float(ref["sample_rate"]))
    with jax.enable_x64(case == "float64"):
        want = j_run.canonical(jax_mesh, SRC, RCV, SIM_TIME,
                               dtype=getattr(jnp, case.split("_")[0]))
        return (np.asarray(want.pressure), np.asarray(want.intensity),
                bool(want.stable), want.sample_rate)


@pytest.mark.parametrize("case", ["float64", "float32_no_fma", "float32"])
def test_canonical_matches_jax(jax_mesh, case, tmp_path):
    """Pressure and intensity series, and ``stable``.

    float64, and float32 against a reference compiled without FMA, hold
    the bound as it stands (they agree to ~1e-13 and to the bit).  Against
    the default float32 reference the bound is 2e-5 per unit of each
    series' peak: XLA's FMAs round differently from torch's separate
    multiply and add, and 300 steps of leapfrog grow that to ~2e-6 of the
    peak (the calibrated impulse peaks near 10 here).
    """
    want_p, want_i, want_ok, want_fs = _jax_reference(jax_mesh, case,
                                                      tmp_path)
    got = t_run.canonical(_port_mesh(jax_mesh), SRC, RCV, SIM_TIME,
                          dtype=getattr(torch, case.split("_")[0]))
    assert got.pressure.shape == want_p.shape == (300,)
    assert got.intensity.shape == want_i.shape == (300, 3)
    assert got.sample_rate == want_fs
    assert bool(got.stable) == want_ok
    for g, w in ((got.pressure, want_p), (got.intensity, want_i)):
        bound = ATOL if case != "float32" else \
            ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound)


@pytest.fixture(scope="module")
def port_mesh():
    return t_run.shoebox_mesh(TBox(*BOX), np.full((1, 8), 0.1), DX, FS,
                              device="cpu")


def _node_problem(mesh, signal, src=(0.7, 0.8, 0.5), rcv=(0.7, 0.8, 1.3),
                  source_cls=HardSource):
    desc = mesh.descriptor
    source = source_cls(node_idx=desc.flat_index(mesh.require_inside(src)),
                        signal=signal)
    node = desc.flat_index(mesh.require_inside(rcv))
    return source, NodeReceiver(node_idx=torch.tensor(node))


def test_state_dtype_float64_close_to_float32(port_mesh):
    """A wider filter state must not change the physics (1e-5, as the JAX
    suite requires of the reference)."""
    source, receiver = _node_problem(port_mesh, impulse_signal(400, 1.0,
                                                               "cpu"))
    init = initial_box_carry(port_mesh.structure, port_mesh.box_spec,
                             receiver, torch.float32, torch.float64)
    assert init[2][3].dtype == torch.float64
    runs = [t_run.run_waveguide_box(port_mesh.structure, port_mesh.box_spec,
                                    source, receiver, 400, state_dtype=sd)
            for sd in (None, torch.float64)]
    np.testing.assert_allclose(runs[0]["outputs"].numpy(),
                               runs[1]["outputs"].numpy(), rtol=0, atol=1e-5)
    assert all(bool(r["stable"]) for r in runs)


@pytest.mark.parametrize("source_cls", [HardSource, SoftSource])
def test_taps_read_post_injection(port_mesh, source_cls):
    """Kernel-injection taps at the source node equal field-injection taps
    (the receiver reads through ``_InjectedView``)."""
    source, receiver = _node_problem(port_mesh, impulse_signal(60, 1.0,
                                                               "cpu"),
                                     rcv=(0.7, 0.8, 0.5),
                                     source_cls=source_cls)
    outs = [t_run.run_waveguide_box(port_mesh.structure, port_mesh.box_spec,
                                    source, receiver, 60,
                                    kernel_inject=k)["outputs"]
            for k in (True, False)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=1e-6)
    assert abs(float(outs[0][0]) - 1.0) < 1e-6


def test_interior_nan_flagged(port_mesh):
    """A NaN born in the interior flips ``stable`` through the final
    full-field check."""
    sig = torch.zeros(6)
    sig[2] = float("nan")
    source, receiver = _node_problem(port_mesh, sig, src=(0.7, 0.8, 0.9),
                                     source_cls=SoftSource)
    out = t_run.run_waveguide_box(port_mesh.structure, port_mesh.box_spec,
                                  source, receiver, 6)
    assert not bool(out["stable"])


def test_execute_raises_on_non_box_mesh(port_mesh, jax_mesh):
    """A mesh without a box spec no longer raises for being no box: it runs
    the region path or the general path and agrees with the box path.  What
    still raises is a structure that was carried across without the
    general-path tables."""
    source, receiver = _node_problem(port_mesh, impulse_signal(40, 1.0,
                                                               "cpu"))
    want = t_run.execute(port_mesh, source, receiver, 40)["outputs"]
    by_regions = dataclasses.replace(port_mesh, box_spec=None)
    general = dataclasses.replace(by_regions, regions=None)
    for mesh in (by_regions, general):
        got = t_run.execute(mesh, source, receiver, 40)
        assert bool(got["stable"])
        np.testing.assert_allclose(got["outputs"].numpy(), want.numpy(),
                                   rtol=0, atol=ATOL)
    bare = dataclasses.replace(_port_mesh(jax_mesh), box_spec=None)
    assert not bare.structure.has_general_tables
    with pytest.raises(ValueError, match="general-path tables"):
        t_run.execute(bare, source, receiver, 4)


def test_port_never_imports_jax():
    """No module of the port names jax, the reference package or the
    reference's ``tools`` scripts, and importing every module of the port
    leaves them out of ``sys.modules``."""
    pkg = REPO / "wayverb_tpu_torch"
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "wayverb_tpu",
                                    "tools"), \
                    f"{path.name} imports {name}"
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__") for p in pkg.rglob("*.py"))
    for name in ("combined.engine", "core.geometry", "core.scene", "convert",
                 "raytracer.accel", "raytracer.mt_kernels",
                 "raytracer.scenes", "waveguide.box_boundary",
                 "tools.probe_resident", "tools.rays_timing",
                 "tools.roofline", "waveguide.run",
                 "waveguide.setup", "waveguide.stencil",
                 "waveguide.stencil_kernels", "waveguide.checkpoint",
                 "utils.events", "combined.model", "combined.validate",
                 "combined.complete", "utils.audio", "waveguide.excitation",
                 "waveguide.naive", "core.kernels", "core.reverb",
                 "parallel.distributed", "tools.rt60", "tools.mic_test",
                 "tools.siltanen2013", "tools.level_match",
                 "tools.waveguide_distance_test", "tools.solution_growth",
                 "tools.sheaffer2014", "tools.boundary_test", "tools.box",
                 "tools.diffuse_decay", "tools.crackly_tunnel",
                 "tools.longrun", "tools.boundary_fit_sweep",
                 "tools.bake_hrtf", "tools.visualize", "tools.gui"):
        assert f"wayverb_tpu_torch.{name}" in modules
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'wayverb_tpu', 'tools')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
