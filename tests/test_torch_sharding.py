"""The port's sharded shoebox paths and data-parallel rays against the JAX
reference, on the CPU, on ``["cpu"] * n`` device meshes: the mesh itself,
the gather-stencil sharded run (``sharding.py``), the fused shoebox run on
x-shards (``box_sharded.py``: B1 with halos, and B5 with halo cotangents in
the backward, by their plain versions here), ``sharded_trace`` and the
hybrid engine with a ``device_mesh``.

Tolerances are the reference suite's for the same comparisons
(``tests/test_sharding.py``): runs 1e-5 absolute against the port's
single-device solvers (directional outputs also rtol 1e-5), ``canonical``
2e-5, gradients rtol 1e-4, traced energy rtol 0.3 of 8/(4πr²), the rendered
IR atol 2e-4, rtol 1e-4.  Against the reference's runs: 2e-5 per unit of
peak, the bound of ``tests/test_torch_general.py`` (XLA contracts a·b + c
into FMAs inside a jitted scan, eager torch does not).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_general import mesh_dict
from test_torch_raytracer import reference_dirac_draws, reference_directions
from wayverb_tpu.core import geometry as jgeo
from wayverb_tpu.parallel import box_sharded as jbs
from wayverb_tpu.parallel import sharding as jps
from wayverb_tpu.waveguide import descriptor as j_desc
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide.receivers import NodeReceiver as JNodeReceiver
from wayverb_tpu.waveguide.receivers import \
    make_directional_receiver as j_directional
from wayverb_tpu.waveguide.sources import HardSource as JHardSource
from wayverb_tpu.waveguide.sources import \
    make_gaussian_source as j_gaussian
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.combined import engine as teng
from wayverb_tpu_torch.core import geometry as tgeo
from wayverb_tpu_torch.core.attenuator import Null
from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.parallel import box_sharded as tbs
from wayverb_tpu_torch.parallel import sharding as tps
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
from wayverb_tpu_torch.waveguide.receivers import (NodeReceiver,
                                                   make_directional_receiver)
from wayverb_tpu_torch.waveguide.sources import (
    HardSource, make_gaussian_source, rectilinear_calibration_factor)

torch.set_num_threads(2)

FS = 3333.33
DX = j_desc.grid_spacing(340.0, 1.0 / FS)
BOX = ((0.0, 0.0, 0.0), (2.0, 2.5, 3.0))
ENV = Environment()
CALIBRATION = rectilinear_calibration_factor(DX, 400.0)
CROSS_REL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close_to_reference(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=CROSS_REL * float(np.abs(want).max()))


def cpu_mesh(n):
    return tps.make_device_mesh(n, devices=["cpu"] * n)


def _impulse(steps, amplitude=1.0):
    sig = np.zeros(steps, np.float32)
    sig[0] = amplitude
    return sig


def _node_problem(desc, src_loc, rcv_loc, sig):
    src = int(desc.flat_index(src_loc))
    rcv = int(desc.flat_index(rcv_loc))
    return ((JHardSource(node_idx=jnp.asarray(src), signal=jnp.asarray(sig)),
             JNodeReceiver(node_idx=jnp.asarray(rcv))),
            (HardSource(node_idx=src, signal=torch.from_numpy(sig)),
             NodeReceiver(node_idx=torch.tensor(rcv))))


# ---------------------------------------------------------------------------
# the mesh

def test_device_mesh():
    """A device may repeat; ``size`` and ``shape`` read as the reference's
    ``Mesh``; without ``devices`` the mesh takes CUDA devices or raises."""
    mesh = tps.make_device_mesh(3, devices=["cpu"] * 5)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.size == 3 and mesh.shape == {"x": 3}
    assert tps.make_device_mesh(devices=["cpu"], axis_name="y").shape == \
        {"y": 1}
    with pytest.raises(ValueError):
        tps.make_device_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        tps.DeviceMesh((torch.device("cpu"),), ("x", "y"))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="devices="):
        tps.make_device_mesh(count + 1)
    if count:
        assert tps.make_device_mesh(1).devices == (torch.device("cuda", 0),)


# ---------------------------------------------------------------------------
# the gather-stencil sharded run (sharding.py)

@pytest.fixture(scope="module")
def small_meshes():
    """The reference's unaligned shoebox mesh (x = 15 does not divide 2, 4
    or 8: ``shard_structure`` pads), and the port's from its tables."""
    jm = j_run.shoebox_mesh(jgeo.Box(*BOX), np.full((1, 8), 0.1), DX, FS)
    return jm, convert.mesh_from_numpy(mesh_dict(jm), "cpu")


@pytest.mark.parametrize("n", [2, 8])
def test_shard_structure_tables_match(small_meshes, n):
    jm, tm = small_meshes
    dims = jm.descriptor.dimensions
    want, want_dims = jps.shard_structure(jm.structure, dims, n)
    got, got_dims = tps.shard_structure(tm.structure, dims, n)
    assert got_dims == tuple(want_dims)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(
            getattr(got, f.name).detach().numpy(),
            np.asarray(getattr(want, f.name)), f.name)


def _flat_padded(loc, padded):
    return int(np.ravel_multi_index(tuple(loc), padded))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_run_waveguide_matches_single(small_meshes, n):
    """The gather-stencil run on n CPU shards against the port's and the
    reference's single-device runs on the same tables."""
    jm, tm = small_meshes
    desc = jm.descriptor
    src_loc = jm.require_inside((1.0, 1.2, 1.5))
    rcv_loc = jm.require_inside((1.0, 1.2, 2.3))
    sig = _impulse(120, CALIBRATION)
    jprob, tprob = _node_problem(desc, src_loc, rcv_loc, sig)
    want = np.asarray(j_run.run_waveguide(jm.structure, desc.dimensions,
                                          *jprob, 120)["outputs"])
    single = t_run.run_waveguide(tm.structure, desc.dimensions, *tprob,
                                 120)["outputs"]
    sharded, padded = tps.shard_structure(tm.structure, desc.dimensions, n)
    got = tps.sharded_run_waveguide(
        cpu_mesh(n), "x", sharded, padded, _flat_padded(src_loc, padded),
        _flat_padded(rcv_loc, padded), sig, 120)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0,
                               atol=1e-5)
    _close_to_reference(got, want)


def test_sharded_run_waveguide_gradient(small_meshes):
    """The adjoint through the halo exchange: d loss / d scale of coef_b is
    finite and non-zero."""
    _, tm = small_meshes
    desc = tm.descriptor
    src_loc = tm.require_inside((1.0, 1.2, 1.5))
    rcv_loc = tm.require_inside((1.0, 1.2, 2.3))
    sharded, padded = tps.shard_structure(tm.structure, desc.dimensions, 4)
    scale = torch.ones((), requires_grad=True)
    out = tps.sharded_run_waveguide(
        cpu_mesh(4), "x",
        dataclasses.replace(sharded, coef_b=sharded.coef_b * scale),
        padded, _flat_padded(src_loc, padded),
        _flat_padded(rcv_loc, padded), _impulse(40), 40)
    torch.sum(out ** 2).backward()
    assert torch.isfinite(scale.grad) and float(scale.grad) != 0.0
    with pytest.raises(ValueError, match="axis"):
        tps.sharded_run_waveguide(cpu_mesh(2), "y", sharded, padded, 0, 0,
                                  _impulse(2), 2)


# ---------------------------------------------------------------------------
# the fused shoebox run on x-shards (box_sharded.py)

@pytest.fixture(scope="module")
def aligned():
    """The shoebox mesh with x padded to a multiple of 8 (so it divides over
    2, 4 and 8 shards), built by both packages with ``align=(8, 1, 1)``."""
    jm = j_run.compute_mesh(jgeo.box_scene(jgeo.Box(*BOX)),
                            np.full((1, 8), 0.1), DX, FS,
                            scene_box=jgeo.Box(*BOX), align=(8, 1, 1))
    tm = t_run.compute_mesh(tgeo.box_scene(tgeo.Box(*BOX)),
                            np.full((1, 8), 0.1), DX, FS,
                            scene_box=tgeo.Box(*BOX), align=(8, 1, 1),
                            device="cpu")
    for name in ("dims", "ilo", "ihi"):
        assert getattr(tm.box_spec, name) == \
            tuple(getattr(jm.box_spec, name)), name
    return jm, tm


@pytest.fixture(scope="module")
def box_node_runs(aligned):
    """The node problem of ``tests/test_sharding.py`` through both
    packages' single-device fused solvers (source injected before each
    step)."""
    jm, tm = aligned
    desc = jm.descriptor
    jprob, tprob = _node_problem(desc, jm.require_inside((1.0, 1.2, 1.5)),
                                 jm.require_inside((0.4, 1.9, 2.3)),
                                 _impulse(120, CALIBRATION))
    want = np.asarray(j_run.run_waveguide_box(
        jm.structure, jm.box_spec, *jprob, 120,
        kernel_inject=False)["outputs"])
    single = t_run.run_waveguide_box(tm.structure, tm.box_spec, *tprob, 120,
                                     kernel_inject=False)["outputs"]
    return tprob, want, single


@pytest.mark.parametrize("n", [2, 4, 8])
def test_box_sharded_node_receiver_matches(aligned, box_node_runs, n):
    _, tm = aligned
    (source, receiver), want, single = box_node_runs
    assert tm.box_spec.dims[0] % n == 0
    out = tbs.run_waveguide_box_sharded(cpu_mesh(n), tm.structure,
                                        tm.box_spec, source, receiver, 120)
    assert bool(out["stable"])
    np.testing.assert_allclose(out["outputs"].numpy(), single.numpy(),
                               rtol=0, atol=1e-5)
    _close_to_reference(out["outputs"], want)


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_box_sharded_source_on_inner_planes(aligned, kind):
    """A point source on the inner y and z planes (the corner line next to
    two walls) in the second of 4 shards: the injection is mirrored onto
    the shard's carried inner-plane rows as on the single device."""
    from wayverb_tpu_torch.waveguide.sources import SoftSource
    _, tm = aligned
    spec, desc = tm.box_spec, tm.descriptor
    xl = spec.dims[0] // 4
    node = desc.flat_index(np.array([xl + 1, spec.ilo[1], spec.ilo[2]]))
    cls = HardSource if kind == "hard" else SoftSource
    source = cls(node_idx=node,
                 signal=torch.from_numpy(_impulse(60, CALIBRATION)))
    receiver = NodeReceiver(node_idx=torch.tensor(desc.flat_index(
        np.array([xl + 2, spec.ilo[1] + 2, spec.ilo[2] + 1]))))
    want = t_run.run_waveguide_box(tm.structure, spec, source, receiver, 60,
                                   kernel_inject=False)["outputs"]
    out = tbs.run_waveguide_box_sharded(cpu_mesh(4), tm.structure, spec,
                                        source, receiver, 60)
    assert bool(out["stable"]) and float(want.abs().max()) > 0
    np.testing.assert_allclose(out["outputs"].numpy(), want.numpy(),
                               rtol=0, atol=1e-5)


def test_box_sharded_directional_receiver_and_gaussian(aligned):
    """A DirectionalReceiver and a near-wall GaussianSource on 8 shards."""
    jm, tm = aligned
    sig = np.zeros(100, np.float32)
    sig[:8] = np.hanning(8)
    want = j_run.run_waveguide_box(
        jm.structure, jm.box_spec,
        j_gaussian(jm.descriptor, (0.5, 1.2, 1.5), 3 * DX, sig,
                   inside=jm.inside),
        j_directional(jm.descriptor, FS, ENV.ambient_density,
                      (1.2, 1.4, 2.0)), 100, kernel_inject=False)["outputs"]
    source = make_gaussian_source(tm.descriptor, (0.5, 1.2, 1.5), 3 * DX,
                                  sig, inside=tm.inside, device="cpu")
    receiver = make_directional_receiver(tm.descriptor, FS,
                                         ENV.ambient_density,
                                         (1.2, 1.4, 2.0), "cpu")
    single = t_run.run_waveguide_box(tm.structure, tm.box_spec, source,
                                     receiver, 100,
                                     kernel_inject=False)["outputs"]
    out = tbs.run_waveguide_box_sharded(cpu_mesh(8), tm.structure,
                                        tm.box_spec, source, receiver, 100)
    assert bool(out["stable"])
    for got, w, s in zip(out["outputs"], want, single):
        assert float(s.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), s.numpy(), rtol=1e-5,
                                   atol=1e-5)
        _close_to_reference(got, w)


def test_box_sharded_gradient_matches_single(aligned):
    """d(Σ taps²)/d coef_b through 4 shards (the plain fused adjoint with
    halo cotangents, routed back by autograd) against the port's
    single-device fused run and ``jax.grad`` of the reference's."""
    jm, tm = aligned
    desc = jm.descriptor
    jprob, (source, receiver) = _node_problem(
        desc, jm.require_inside((1.0, 1.2, 1.5)),
        jm.require_inside((0.4, 1.9, 2.3)), _impulse(60))

    def loss_ref(coef_b):
        s = dataclasses.replace(jm.structure, coef_b=coef_b)
        return jnp.sum(j_run.run_waveguide_box(
            s, jm.box_spec, *jprob, 60, kernel_inject=False)["outputs"] ** 2)

    want = np.asarray(jax.grad(loss_ref)(jm.structure.coef_b))

    def grad(run):
        coef_b = tm.structure.coef_b.clone().requires_grad_(True)
        out = run(dataclasses.replace(tm.structure, coef_b=coef_b))
        torch.sum(out["outputs"] ** 2).backward()
        return coef_b.grad.numpy()

    g_sh = grad(lambda s: tbs.run_waveguide_box_sharded(
        cpu_mesh(4), s, tm.box_spec, source, receiver, 60))
    g_si = grad(lambda s: t_run.run_waveguide_box(
        s, tm.box_spec, source, receiver, 60, kernel_inject=False))
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(g_sh, g_si, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(g_sh, want, rtol=1e-4, atol=1e-9)


# The reference's sharded run with its boundary-filter state in float64:
# the reference needs x64, a process-wide switch, so the run is made in a
# child process (as tests/test_torch_fit_tools.py does).  The child builds
# the ``aligned`` mesh with x64 off, as the port's is built, then switches
# it on for the run.
F64_SHARDED_CHILD = """
import json, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from wayverb_tpu.core import geometry as jgeo
from wayverb_tpu.parallel import box_sharded as jbs
from wayverb_tpu.parallel import sharding as jps
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide.receivers import NodeReceiver
from wayverb_tpu.waveguide.sources import HardSource
a = json.loads(sys.argv[1])
box = jgeo.Box(*a["box"])
mesh = j_run.compute_mesh(jgeo.box_scene(box), np.full((1, 8), 0.1),
                          a["dx"], a["fs"], scene_box=box, align=(8, 1, 1))
sig = np.zeros(a["steps"], np.float32)
sig[0] = a["amplitude"]
source = HardSource(node_idx=jnp.asarray(a["src"]), signal=jnp.asarray(sig))
receiver = NodeReceiver(node_idx=jnp.asarray(a["rcv"]))
jax.config.update("jax_enable_x64", True)
out = jbs.run_waveguide_box_sharded(
    jps.make_device_mesh(a["shards"]), mesh.structure, mesh.box_spec, source,
    receiver, a["steps"], state_dtype=jnp.float64)
print(json.dumps({"dims": list(mesh.box_spec.dims),
                  "stable": bool(out["stable"]),
                  "outputs": np.asarray(out["outputs"]).tolist()}))
"""


@pytest.fixture(scope="module")
def f64_state_runs(aligned, box_node_runs):
    """The node problem of ``box_node_runs`` with the boundary-filter state
    in float64: the port's single-device fused run, and its sharded runs by
    shard count, made once."""
    _, tm = aligned
    (source, receiver), _, _ = box_node_runs
    single = t_run.run_waveguide_box(
        tm.structure, tm.box_spec, source, receiver, 120, kernel_inject=False,
        state_dtype=torch.float64)

    @functools.cache
    def sharded(n):
        return tbs.run_waveguide_box_sharded(
            cpu_mesh(n), tm.structure, tm.box_spec, source, receiver, 120,
            state_dtype=torch.float64)

    return single, sharded


@pytest.mark.parametrize("n", [2, 4])
def test_box_sharded_state_dtype_matches_single(box_node_runs,
                                                 f64_state_runs, n):
    """``state_dtype=torch.float64`` on 2 and 4 shards against the port's
    single-device fused run with the same state dtype, at the sharded
    runs' 1e-5 of peak; the fields stay float32, and the float64 state
    changes the outputs' bits against the float32-state run."""
    _, _, single_f32 = box_node_runs
    single, sharded = f64_state_runs
    out = sharded(n)
    want = single["outputs"]
    peak = float(want.abs().max())
    assert bool(out["stable"]) and bool(single["stable"]) and peak > 0
    assert out["outputs"].dtype == torch.float32
    np.testing.assert_allclose(out["outputs"].numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * peak)
    assert not torch.equal(out["outputs"], single_f32)


def test_box_sharded_state_dtype_matches_reference(aligned, f64_state_runs):
    """The port's 4-shard run with ``state_dtype=torch.float64`` against
    the reference's with ``state_dtype=jnp.float64`` (x64 on, in a child
    process), within 2e-5 of peak (``_close_to_reference``)."""
    jm, _ = aligned
    desc = jm.descriptor
    args = {"box": BOX, "dx": float(DX), "fs": FS, "steps": 120,
            "amplitude": float(CALIBRATION), "shards": 4,
            "src": int(desc.flat_index(jm.require_inside((1.0, 1.2, 1.5)))),
            "rcv": int(desc.flat_index(jm.require_inside((0.4, 1.9, 2.3))))}
    proc = subprocess.run(
        [sys.executable, "-c", F64_SHARDED_CHILD, json.dumps(args)],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_count"
                                     "=8 --xla_cpu_max_isa=AVX"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    assert want["dims"] == list(jm.box_spec.dims) and want["stable"]
    out = f64_state_runs[1](4)
    assert bool(out["stable"])
    _close_to_reference(out["outputs"], np.asarray(want["outputs"],
                                                   np.float32))


def test_box_sharded_midrun_nan_flagged(aligned):
    """A NaN injected mid-run flips the sharded run's ``stable``."""
    _, tm = aligned
    desc = tm.descriptor
    sig = np.ones(40, np.float32)
    sig[25] = np.nan
    source = HardSource(node_idx=desc.flat_index(
        tm.require_inside((1.0, 1.2, 1.5))), signal=torch.from_numpy(sig))
    receiver = NodeReceiver(node_idx=torch.tensor(desc.flat_index(
        tm.require_inside((0.4, 1.9, 2.3)))))
    out = tbs.run_waveguide_box_sharded(cpu_mesh(4), tm.structure,
                                        tm.box_spec, source, receiver, 40)
    assert not bool(out["stable"])


def test_box_sharded_needs_x_to_divide(aligned):
    _, tm = aligned
    (source, receiver) = _node_problem(tm.descriptor, (4, 4, 4), (4, 4, 5),
                                       _impulse(2))[1]
    with pytest.raises(ValueError, match="divisible"):
        tbs.run_waveguide_box_sharded(cpu_mesh(3), tm.structure, tm.box_spec,
                                      source, receiver, 2)


def test_padded_grid_serial_order_matches():
    """A padded grid whose x planes land on a shard boundary, which the
    reference's ``overlap_supported`` refuses (so its serial order runs
    there, the order the port always runs): the sharded run matches the
    single-device solver."""
    box = ((0.0, 0.0, 0.0), (DX * 13, 1.6, 1.8))
    tm = t_run.compute_mesh(tgeo.box_scene(tgeo.Box(*box)),
                            np.full((1, 8), 0.12), DX, FS,
                            scene_box=tgeo.Box(*box), align=(32, 8, 128),
                            device="cpu")
    spec = tm.box_spec
    assert spec.dims == (32, 16, 128)
    assert not tbs.overlap_supported(spec, spec.dims[0] // 4)
    _, (source, receiver) = _node_problem(
        tm.descriptor, tm.require_inside((DX * 6, 0.8, 0.5)),
        tm.require_inside((DX * 6, 0.8, 1.3)), _impulse(60))
    want = t_run.run_waveguide_box(tm.structure, spec, source, receiver, 60,
                                   kernel_inject=False)["outputs"]
    out = tbs.run_waveguide_box_sharded(cpu_mesh(4), tm.structure, spec,
                                        source, receiver, 60)
    assert bool(out["stable"]) and float(want.abs().max()) > 0
    np.testing.assert_allclose(out["outputs"].numpy(), want.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("xl", [1, 2, 3, 4, 8, 16])
def test_overlap_supported_matches_reference(aligned, xl):
    jm, tm = aligned
    for ilo, ihi in ((2, 13), (8, 15), (2, 14), (3, 7), (16, 23)):
        jspec = dataclasses.replace(jm.box_spec, dims=(64, 19, 21),
                                    ilo=(ilo, 2, 2), ihi=(ihi, 15, 17))
        tspec = dataclasses.replace(tm.box_spec, dims=(64, 19, 21),
                                    ilo=(ilo, 2, 2), ihi=(ihi, 15, 17))
        assert tbs.overlap_supported(tspec, xl) == \
            jbs.overlap_supported(jspec, xl), (ilo, ihi, xl)


def test_canonical_sharded_matches_canonical(aligned):
    """The engine's sharded shoebox leg on 8 shards against ``canonical``
    (whose fused path injects inside the step)."""
    _, tm = aligned
    single = t_run.canonical(tm, (1.0, 1.2, 1.5), (1.0, 1.2, 2.3), 0.03)
    got = tbs.canonical_sharded(tm, (1.0, 1.2, 1.5), (1.0, 1.2, 2.3), 0.03,
                                cpu_mesh(8))
    assert bool(got.stable) and got.sample_rate == single.sample_rate
    np.testing.assert_allclose(got.pressure.numpy(), single.pressure.numpy(),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.intensity.numpy(),
                               single.intensity.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="shoebox"):
        tbs.canonical_sharded(dataclasses.replace(tm, box_spec=None),
                              (1.0, 1.2, 1.5), (1.0, 1.2, 2.3), 0.03,
                              cpu_mesh(8))


@pytest.mark.parametrize("src_x", [3, 10])
def test_fused_bwd_zeroes_only_a_hard_source_inside_the_shard(src_x):
    """A shard's fused-step adjoint with a hard source: the port zeroes the
    cur/prev cotangents at the source only when the shard holds it.  The
    reference's ``_fused_bwd`` indexes ``x − offset`` with JAX's wrapping
    index, so a source in another shard (x = 3 against the shard's rows
    8..15) zeroes the unrelated local row 3 instead; everywhere else the two
    agree.  The sharded runs inject before the step (no in-kernel source),
    so the difference never reaches them in either package."""
    from wayverb_tpu.waveguide import box_fused as jbf
    from wayverb_tpu_torch.waveguide import box_fused as tbf
    inside = np.zeros((16, 10, 12), dtype=bool)
    inside[2:14, 2:8, 2:10] = True
    tspec, jspec = tbf.spec_from_inside(inside), jbf.spec_from_inside(inside)
    rng = np.random.default_rng(src_x)
    shapes = tbf._plane_shapes(8, 10, 12)
    g = rng.normal(size=(8, 10, 12)).astype(np.float32)
    ginner = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    inj = (src_x, 5, 6, 1)
    geom = tspec.geom_array(x_offset=8)
    got = tbf.fused_step_bwd(geom, torch.from_numpy(g),
                             tuple(torch.from_numpy(a) for a in ginner), inj)
    free = tbf.fused_step_bwd(geom, torch.from_numpy(g),
                              tuple(torch.from_numpy(a) for a in ginner))
    zeros = lambda *sh: jnp.zeros(sh, jnp.float32)  # noqa: E731
    _, vjp = jax.vjp(
        lambda c, p: jbf.fused_step(
            jspec, jspec.geom_array(x_offset=8), c, p,
            tuple(zeros(*sh) for sh in shapes),
            jnp.asarray(inj, jnp.int32), jnp.zeros(2, jnp.float32)),
        zeros(8, 10, 12), zeros(8, 10, 12))
    want_cur, want_prev = vjp((jnp.asarray(g),
                               tuple(jnp.asarray(a) for a in ginner)))
    lx = src_x - 8
    for port, ref, unzeroed in ((got[0], want_cur, free[0]),
                                (got[1], want_prev, free[1])):
        ref = np.array(ref)
        port = port.numpy()
        if 0 <= lx < 8:
            assert port[lx, 5, 6] == 0.0 == ref[lx, 5, 6]
        else:
            assert np.array_equal(port, unzeroed.numpy())
            assert ref[lx, 5, 6] == 0.0 != port[lx, 5, 6]
            ref[lx, 5, 6] = port[lx, 5, 6]
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# data-parallel rays and the engine

def test_sharded_trace_energy_scale():
    """The summed histogram's direct energy over 8 shards of 8192 rays:
    within rtol 0.3 of 8 bands × 1/(4πr²)."""
    box = tgeo.Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    surf = Surface(absorption=torch.full((1, 8), 1.0),
                   scattering=torch.full((1, 8), 0.0))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    hist = tps.sharded_trace(cpu_mesh(8), "x", tgeo.box_scene(box), surf,
                             src, rcv, torch.Generator().manual_seed(0),
                             rays_per_device=8192, depth=1, max_time=0.2)
    r = np.linalg.norm(np.subtract(src, rcv))
    np.testing.assert_allclose(float(hist.sum()), 8 / (4 * np.pi * r * r),
                               rtol=0.3)


@pytest.mark.parametrize("scene_box", [True, False])
def test_engine_render_matches_single(scene_box):
    """``Engine(device_mesh=…)`` (8 CPU shards; the shoebox and the general
    sharded path) against the single-device engine on the same mesh, with
    the reference's ray and dirac draws."""
    box = tgeo.Box((0.0, 0.0, 0.0), (1.8, 2.1, 2.4))
    surf = Surface(absorption=torch.full((1, 8), 0.15),
                   scattering=torch.full((1, 8), 0.1))
    rp = teng.RaytracerParameters(rays=1024, max_time=0.4)
    kw = dict(scene_box=box) if scene_box else {}
    eng1 = teng.Engine(tgeo.box_scene(box), surf, device_mesh=cpu_mesh(8),
                       device="cpu", **kw)
    eng0 = teng.Engine(tgeo.box_scene(box), surf, device="cpu", **kw)
    eng0.mesh = eng1.mesh
    assert (eng1.mesh.box_spec is not None) == scene_box
    src, rcv = (0.9, 1.0, 0.7), (0.9, 1.0, 1.8)
    key = jax.random.PRNGKey(11)
    directions = reference_directions(key, rp.rays,
                                      teng.optimum_depth(eng1.surfaces))
    launches = tsk.weighted_step_sharded.launches
    r1 = eng1.run(src, rcv, None, rp, waveguide_time=0.05,
                  directions=directions)
    r0 = eng0.run(src, rcv, None, rp, waveguide_time=0.05,
                  directions=directions)
    assert tsk.weighted_step_sharded.launches == launches
    n = int(np.ceil(r1.stochastic_histogram.shape[0]
                    / r1.histogram_sample_rate * 8000.0))
    draws = reference_dirac_draws(jax.random.PRNGKey(1), n)
    ir1 = teng.render(r1, Null(), 8000.0, draws=draws).numpy()
    ir0 = teng.render(r0, Null(), 8000.0, draws=draws).numpy()
    assert np.all(np.isfinite(ir1)) and np.abs(ir0).max() > 0
    np.testing.assert_allclose(ir1, ir0, atol=2e-4, rtol=1e-4)
    p1, p0 = (r.waveguide_bands[0].pressure for r in (r1, r0))
    if scene_box:
        np.testing.assert_allclose(p1.numpy(), p0.numpy(), rtol=0,
                                   atol=2e-5)
    else:
        assert torch.equal(p1, p0)
