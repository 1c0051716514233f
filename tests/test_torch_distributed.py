"""The port's sharded waveguides across processes (``parallel/distributed``)
on the CPU, with ``gloo``: ranks spawned in two layouts, four processes of
one shard and two processes of two shards, each run the same problems over
``distributed.global_device_mesh(devices=["cpu"] * k)`` and save what they
get; the cases compare that with the one-process four-shard mesh and with
the reference.

Bounds: forward runs equal the one-process ``["cpu"] * 4`` mesh (0.0) and
lie within 1e-5 of the reference's sharded run on four virtual devices
(``tests/test_multihost.py``'s bound); gradients within 1e-5 of the largest
component of the one-process gradient (summed across processes in another
order) and within rtol 1e-4, atol 1e-7 of ``jax.grad``
(``tests/test_torch_general_sharded.py``); ``Engine`` run + render equal on
every rank and equal to the one-process mesh's; ``sharded_trace`` equal to
the one-process run with the same generator.

Run as a script, this file is one rank's worker:

    python tests/test_torch_distributed.py run RANK WORLD PORT SHARDS OUT_DIR
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from wayverb_tpu_torch.combined import engine as teng  # noqa: E402
from wayverb_tpu_torch.core import geometry as tgeo  # noqa: E402
from wayverb_tpu_torch.core.attenuator import Null  # noqa: E402
from wayverb_tpu_torch.core.orientation import \
    random_unit_vectors  # noqa: E402
from wayverb_tpu_torch.core.surfaces import Surface  # noqa: E402
from wayverb_tpu_torch.parallel import box_sharded as tbs  # noqa: E402
from wayverb_tpu_torch.parallel import distributed as tdist  # noqa: E402
from wayverb_tpu_torch.parallel import general_sharded as tgs  # noqa: E402
from wayverb_tpu_torch.parallel import sharding as tps  # noqa: E402
from wayverb_tpu_torch.waveguide import run as t_run  # noqa: E402
from wayverb_tpu_torch.waveguide.descriptor import \
    grid_spacing  # noqa: E402
from wayverb_tpu_torch.waveguide.receivers import NodeReceiver  # noqa: E402
from wayverb_tpu_torch.waveguide.sources import HardSource  # noqa: E402

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)
BOX = ((0.0, 0.0, 0.0), (2.0, 2.5, 3.0))
SRC, RCV = (1.0, 1.2, 1.5), (0.4, 1.9, 2.3)
STEPS = 60
GRAD_STEPS = 40
SHARDS = 4
LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2)}
TIMEOUT = 120         # seconds: the process group's, and a failing peer's
ENGINE_BOX = ((0.0, 0.0, 0.0), (1.8, 2.1, 2.4))
ENGINE_RAYS = 512
FWD_ATOL = 1e-5       # tests/test_multihost.py
GRAD_REL = 1e-5       # of the largest component, across processes


# ---------------------------------------------------------------------------
# the problems, run alike by every rank and by the one-process mesh

def _meshes():
    """The box of ``tests/test_torch_sharding.py`` as a shoebox mesh and as
    a general mesh, x aligned to the shard count."""
    scene = tgeo.box_scene(tgeo.Box(*BOX))
    box = t_run.compute_mesh(scene, np.full((1, 8), 0.1), DX, FS,
                             scene_box=tgeo.Box(*BOX), align=(SHARDS, 1, 1),
                             device="cpu")
    general = t_run.compute_mesh(scene, np.full((1, 8), 0.1), DX, FS,
                                 align=(SHARDS, 1, 1), device="cpu")
    return box, general


def _problem(mesh, steps):
    """A unit impulse at SRC, a node receiver at RCV (flat indices)."""
    desc = mesh.descriptor
    sig = np.zeros(steps, np.float32)
    sig[0] = 1.0
    return (int(desc.flat_index(mesh.require_inside(SRC))),
            int(desc.flat_index(mesh.require_inside(RCV))), sig)


def _port_problem(mesh, steps):
    src, rcv, sig = _problem(mesh, steps)
    return (HardSource(node_idx=src, signal=torch.from_numpy(sig)),
            NodeReceiver(node_idx=torch.tensor(rcv)))


def _coef_b_grad(run, structure):
    coef_b = structure.coef_b.detach().clone().requires_grad_(True)
    out = run(dataclasses.replace(structure, coef_b=coef_b))
    torch.sum(out["outputs"] ** 2).backward()
    return coef_b.grad


def _engine_ir(device_mesh, scene_box: bool):
    """``Engine(device_mesh=…)`` run + render: fixed directions and render
    generator, so one-process and several-process runs see the same
    draws."""
    box = tgeo.Box(*ENGINE_BOX)
    surf = Surface(absorption=torch.full((1, 8), 0.15),
                   scattering=torch.full((1, 8), 0.1))
    rp = teng.RaytracerParameters(rays=ENGINE_RAYS, max_time=0.3)
    kw = dict(scene_box=box) if scene_box else {}
    e = teng.Engine(tgeo.box_scene(box), surf, device_mesh=device_mesh,
                    device="cpu", **kw)
    gen = torch.Generator().manual_seed(11)
    depth = teng.optimum_depth(e.surfaces)
    directions = (random_unit_vectors(ENGINE_RAYS, gen),
                  torch.stack([random_unit_vectors(ENGINE_RAYS, gen)
                               for _ in range(depth)]))
    r = e.run((0.9, 1.0, 0.7), (0.9, 1.0, 1.8), None, rp,
              waveguide_time=0.04, directions=directions)
    ir = teng.render(r, Null(), 8000.0, torch.Generator().manual_seed(1))
    return ir, r.waveguide_bands[0].pressure, r.waveguide_bands[0].stable


def _trace(device_mesh):
    box = tgeo.Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    surf = Surface(absorption=torch.full((1, 8), 1.0),
                   scattering=torch.full((1, 8), 0.0))
    return tps.sharded_trace(device_mesh, "x", tgeo.box_scene(box), surf,
                             (2.09, 2.12, 2.12), (2.09, 3.08, 0.96),
                             torch.Generator().manual_seed(0),
                             rays_per_device=1024, depth=2, max_time=0.2)


def run_all(device_mesh) -> dict:
    """Every result the cases compare, on ``device_mesh``."""
    box, general = _meshes()
    dims = general.descriptor.dimensions
    out = {}
    r = tbs.run_waveguide_box_sharded(device_mesh, box.structure,
                                      box.box_spec,
                                      *_port_problem(box, STEPS), STEPS)
    out["box_forward"], out["box_stable"] = r["outputs"], r["stable"]
    r = tgs.run_waveguide_general_sharded(device_mesh, general.structure,
                                          dims,
                                          *_port_problem(general, STEPS),
                                          STEPS)
    out["general_forward"], out["general_stable"] = r["outputs"], \
        r["stable"]
    problem = _port_problem(box, GRAD_STEPS)
    out["box_gradient"] = _coef_b_grad(
        lambda s: tbs.run_waveguide_box_sharded(
            device_mesh, s, box.box_spec, *problem, GRAD_STEPS),
        box.structure)
    problem = _port_problem(general, GRAD_STEPS)
    for every in (0, 16):
        out[f"general_gradient_{every}"] = _coef_b_grad(
            lambda s: tgs.run_waveguide_general_sharded(
                device_mesh, s, dims, *problem, GRAD_STEPS,
                checkpoint_every=every), general.structure)
    for scene_box in (True, False):
        name = "engine_box" if scene_box else "engine_general"
        ir, pressure, stable = _engine_ir(device_mesh, scene_box)
        out[name], out[name + "_pressure"] = ir, pressure
        out[name + "_stable"] = stable
    out["trace"] = _trace(device_mesh)
    return {k: v.detach().clone() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the worker

def worker(mode, rank, world, port, shards, out_dir):
    """One rank of ``spawn``; ``mode`` "single" runs the one-process
    four-shard mesh without ``torch.distributed``."""
    torch.set_num_threads(1)
    rank, world, shards = int(rank), int(world), int(shards)
    if mode == "single":
        res = run_all(tps.make_device_mesh(SHARDS, devices=["cpu"] * SHARDS))
        torch.save(res, os.path.join(out_dir, "single.pt"))
        return
    tdist.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     timeout=TIMEOUT)
    mesh = tdist.global_device_mesh(devices=["cpu"] * shards)
    if mode == "fail":
        if rank == world - 1:
            raise RuntimeError("rank fails on purpose")
        box, _ = _meshes()
        tbs.run_waveguide_box_sharded(mesh, box.structure, box.box_spec,
                                      *_port_problem(box, STEPS), STEPS)
        return
    t0 = time.perf_counter()
    res = run_all(mesh)
    res["api"] = {"process_count": tdist.process_count(),
                  "is_coordinator": tdist.is_coordinator(),
                  "owners": mesh.owners, "rank": mesh.rank,
                  "local_shards": mesh.local_shards,
                  "devices": [str(d) for d in mesh.devices],
                  "seconds": time.perf_counter() - t0,
                  "transport": dict(tps.transport_stats)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(mode, world, shards, out_dir):
    """Start ``world`` ranks of this file's worker (one thread each)."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), str(port), str(shards), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for rank in range(world)]


def finish(procs, t0, limit):
    """(return codes, outputs) of ``start``'s processes; any still running
    ``limit`` seconds after ``t0`` is killed."""
    outs = []
    try:
        for p in procs:
            left = max(limit - (time.perf_counter() - t0), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


# ---------------------------------------------------------------------------
# the cases

def _reference():
    """The reference's sharded runs on four of conftest's virtual CPU
    devices, and ``jax.grad`` of its single-device runs."""
    import jax
    import jax.numpy as jnp
    from wayverb_tpu.core import geometry as jgeo
    from wayverb_tpu.parallel import box_sharded as jbs
    from wayverb_tpu.parallel import general_sharded as jgs
    from wayverb_tpu.parallel import sharding as jps
    from wayverb_tpu.waveguide import run as j_run
    from wayverb_tpu.waveguide.receivers import NodeReceiver as JNode
    from wayverb_tpu.waveguide.sources import HardSource as JHard

    scene = jgeo.box_scene(jgeo.Box(*BOX))
    box = j_run.compute_mesh(scene, np.full((1, 8), 0.1), DX, FS,
                             scene_box=jgeo.Box(*BOX), align=(SHARDS, 1, 1))
    general = j_run.compute_mesh(scene, np.full((1, 8), 0.1), DX, FS,
                                 align=(SHARDS, 1, 1))
    dims = general.descriptor.dimensions

    def problem(mesh, steps):
        src, rcv, sig = _problem(mesh, steps)
        return (JHard(node_idx=jnp.asarray(src), signal=jnp.asarray(sig)),
                JNode(node_idx=jnp.asarray(rcv)))

    jmesh = jps.make_device_mesh(SHARDS)
    out = {"box_forward": jbs.run_waveguide_box_sharded(
               jmesh, box.structure, box.box_spec, *problem(box, STEPS),
               STEPS)["outputs"],
           "general_forward": jgs.run_waveguide_general_sharded(
               jmesh, general.structure, dims, *problem(general, STEPS),
               STEPS)["outputs"]}

    def box_loss(coef_b):
        s = dataclasses.replace(box.structure, coef_b=coef_b)
        return jnp.sum(j_run.run_waveguide_box(
            s, box.box_spec, *problem(box, GRAD_STEPS), GRAD_STEPS,
            kernel_inject=False)["outputs"] ** 2)

    def general_loss(coef_b):
        s = dataclasses.replace(general.structure, coef_b=coef_b)
        return jnp.sum(j_run.run_waveguide(
            s, dims, *problem(general, GRAD_STEPS),
            GRAD_STEPS)["outputs"] ** 2)

    out["box_gradient"] = jax.grad(box_loss)(box.structure.coef_b)
    out["general_gradient"] = jax.grad(general_loss)(general.structure.coef_b)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks and the one-process mesh, all started at once,
    and the reference's runs in this process meanwhile: ({layout: every
    rank's results}, one-process results, reference results)."""
    t0 = time.perf_counter()
    dirs = {name: tmp_path_factory.mktemp(f"ranks_{name}")
            for name in [*LAYOUTS, "single"]}
    procs = {name: start("run", world, shards, dirs[name])
             for name, (world, shards) in LAYOUTS.items()}
    procs["single"] = start("single", 1, SHARDS, dirs["single"])
    reference = _reference()
    ranks = {}
    for name, group in procs.items():
        rcs, outs = finish(group, t0, limit=400)
        assert rcs == [0] * len(group), "\n".join(o[-3000:] for o in outs)
        if name != "single":
            ranks[name] = [torch.load(dirs[name] / f"rank{r}.pt")
                           for r in range(len(group))]
    return ranks, torch.load(dirs["single"] / "single.pt"), reference


@pytest.fixture(params=list(LAYOUTS))
def ranks(request, runs):
    return request.param, runs[0][request.param]


@pytest.fixture
def single(runs):
    return runs[1]


@pytest.fixture
def reference(runs):
    return runs[2]


def test_api_and_layout(ranks):
    """``process_count``, ``is_coordinator`` and the mesh: shard i lives on
    rank i // (shards a rank), every rank sees the same owners."""
    layout, results = ranks
    world, shards = LAYOUTS[layout]
    for rank, res in enumerate(results):
        api = res["api"]
        assert api["process_count"] == world
        assert api["is_coordinator"] == (rank == 0)
        assert api["rank"] == rank
        assert api["owners"] == tuple(i // shards for i in range(SHARDS))
        assert api["local_shards"] == tuple(range(rank * shards,
                                                  (rank + 1) * shards))
        assert api["devices"] == ["cpu"] * SHARDS
        # halo rows crossed between processes, and only where a neighbour
        # shard lives on another process
        assert api["transport"]["bytes_sent"] > 0


@pytest.mark.parametrize("path", ["box", "general"])
def test_forward_equals_one_process_and_reference(ranks, single, reference,
                                                  path):
    _, results = ranks
    want = single[f"{path}_forward"]
    ref = reference[f"{path}_forward"]
    assert float(np.abs(ref).max()) > 0
    for res in results:
        got = res[f"{path}_forward"]
        assert bool(res[f"{path}_stable"])
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", ["box_gradient", "general_gradient_0",
                                  "general_gradient_16"])
def test_gradient_matches_one_process_and_jax_grad(ranks, single, reference,
                                                   name):
    """d(Σ taps²)/d coef_b on every rank, with and without
    ``checkpoint_every=16`` on the general mesh."""
    _, results = ranks
    want = single[name].numpy()
    ref = reference["box_gradient" if name == "box_gradient"
                    else "general_gradient"]
    scale = float(np.abs(want).max())
    assert scale > 0
    for res in results:
        got = res[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", ["engine_box", "engine_general"])
def test_engine_ir_equal_on_every_rank(ranks, single, name):
    """``Engine(device_mesh=global_device_mesh(…))`` run + render: the IR
    and the waveguide band equal on every rank and equal to the one-process
    mesh's with the same directions."""
    _, results = ranks
    assert float(single[name].abs().max()) > 0
    for res in results:
        assert bool(res[name + "_stable"])
        assert torch.equal(res[name], results[0][name])
        np.testing.assert_array_equal(res[name].numpy(),
                                      single[name].numpy())
        np.testing.assert_array_equal(res[name + "_pressure"].numpy(),
                                      single[name + "_pressure"].numpy())


def test_sharded_trace_across_processes(ranks, single):
    """Each rank traces its shards' rays (the others' draws dropped), the
    histograms summed across processes, then in shard order: equal to the
    one-process run with the same generator."""
    _, results = ranks
    assert float(single["trace"].sum()) > 0
    for res in results:
        assert torch.equal(res["trace"], single["trace"])


def test_failing_rank_fails_its_peers(tmp_path):
    """A rank that raises before the run: its peer, waiting in the first
    exchange, fails too, well within the limit, and nothing hangs."""
    t0 = time.perf_counter()
    rcs, outs = finish(start("fail", 2, 2, tmp_path), t0, limit=4 * TIMEOUT)
    seconds = time.perf_counter() - t0
    assert rcs[1] != 0 and "rank fails on purpose" in outs[1]
    assert rcs[0] != 0, outs[0][-2000:]
    assert seconds < 2 * TIMEOUT + 30, seconds


if __name__ == "__main__":
    worker(*sys.argv[1:])
