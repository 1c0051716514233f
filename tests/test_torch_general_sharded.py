"""The port's sharded general waveguide against the JAX reference, on the
CPU: the plain versions of the shard step (B10) and its adjoint (B11)
against the reference's ``weighted_step_sharded`` and ``jax.vjp`` of it, the
shard tables, ``compute_mesh(align=)``, and ``run_waveguide_general_sharded``
on ``["cpu"] * n`` meshes against the reference's sharded run on its virtual
devices and against the port's single-device run, values and gradients.

Tolerances: the shard step and its adjoint 1e-5 of peak; runs 5e-5
(``tests/test_general_sharded.py``) against the reference and 0.0 against
the port's single-device run (the halo rows enter the sum where the unsplit
step reads the neighbour); gradients rtol 1e-4, atol 1e-7
(``tests/test_general_sharded.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_general import mesh_dict
from wayverb_tpu.core import geometry as jgeo
from wayverb_tpu.parallel import general_sharded as jgs
from wayverb_tpu.parallel import sharding as jps
from wayverb_tpu.waveguide import descriptor as j_desc
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide import stencil_pallas as jsp
from wayverb_tpu.waveguide.receivers import NodeReceiver as JNodeReceiver
from wayverb_tpu.waveguide.sources import HardSource as JHardSource
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core import geometry as tgeo
from wayverb_tpu_torch.parallel import general_sharded as tgs
from wayverb_tpu_torch.parallel.sharding import make_device_mesh
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import setup as t_setup
from wayverb_tpu_torch.waveguide import stencil_kernels as tsk
from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
from wayverb_tpu_torch.waveguide.sources import (
    HardSource, rectilinear_calibration_factor)

torch.set_num_threads(2)

FS = 3333.33
DX = j_desc.grid_spacing(340.0, 1.0 / FS)
BOX = ((0.0, 0.0, 0.0), (2.0, 2.5, 3.0))
SRC, RCV = (1.0, 1.2, 1.5), (0.4, 1.9, 2.3)
STEPS = 120
KERNEL_REL = 1e-5
RUN_ATOL = 5e-5
TABLES = tuple(t_setup.GENERAL_TABLE_DTYPES)


def cpu_mesh(n):
    return make_device_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def meshes():
    """The box of ``tests/test_general_sharded.py`` as a GENERAL mesh
    (no ``scene_box``), x aligned to 8: the reference's, and the port's
    built from its tables."""
    jm = j_run.compute_mesh(jgeo.box_scene(jgeo.Box(*BOX)),
                            np.full((1, 8), 0.1), DX, FS, align=(8, 1, 1))
    assert jm.box_spec is None and jm.descriptor.dimensions[0] % 8 == 0
    return jm, convert.mesh_from_numpy(mesh_dict(jm), "cpu")


def _problem(jm, steps=STEPS):
    desc = jm.descriptor
    src = int(desc.flat_index(jm.require_inside(SRC)))
    rcv = int(desc.flat_index(jm.require_inside(RCV)))
    sig = np.zeros(steps, np.float32)
    sig[0] = rectilinear_calibration_factor(DX, 400.0)
    jprob = (JHardSource(node_idx=jnp.asarray(src), signal=jnp.asarray(sig)),
             JNodeReceiver(node_idx=jnp.asarray(rcv)))
    tprob = (HardSource(node_idx=src, signal=torch.from_numpy(sig)),
             NodeReceiver(node_idx=torch.tensor(rcv)))
    return jprob, tprob


def _shard_case(xl, seed, Y=7, Z=9):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    code = rng.integers(0, 1 << 13, size=(xl, Y, Z)).astype(np.int32)
    return (f32(xl, Y, Z), f32(xl, Y, Z), code, f32(1, Y, Z), f32(1, Y, Z),
            f32(xl, Y, Z))


def _rel_close(got, want, rel=KERNEL_REL):
    want = np.asarray(want)
    peak = float(np.abs(want).max())
    assert peak > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * peak)


# ---------------------------------------------------------------------------
# the shard step (B10) and its adjoint (B11)

@pytest.mark.parametrize("xl", [1, 2, 8])
def test_weighted_step_sharded_plain_matches_reference(xl):
    """B10's plain version against the reference's ``weighted_step_sharded``
    (its jnp form off the TPU) with non-zero halos; xl = 1 reads both halos
    at one row."""
    cur, prev, code, hlo, hhi, _ = _shard_case(xl, 10 + xl)
    want = jsp.weighted_step_sharded(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(code),
        (jnp.asarray(hlo), jnp.asarray(hhi)))
    before = tsk.weighted_step_sharded.launches
    got = tsk.weighted_step_sharded(
        *(torch.from_numpy(a) for a in (cur, prev, code)),
        (torch.from_numpy(hlo), torch.from_numpy(hhi)))
    assert tsk.weighted_step_sharded.launches == before
    _rel_close(got, want)


@pytest.mark.parametrize("xl", [1, 2, 8])
def test_weighted_step_sharded_bwd_plain_matches_jax_vjp(xl):
    """B11's plain version against ``jax.vjp`` of the reference's shard step:
    the cotangents of cur and of both halo rows."""
    cur, prev, code, hlo, hhi, g = _shard_case(xl, 20 + xl)
    jcode = jnp.asarray(code)
    _, vjp = jax.vjp(
        lambda c, h0, h1: jsp.weighted_step_sharded(
            c, jnp.asarray(prev), jcode, (h0, h1)),
        jnp.asarray(cur), jnp.asarray(hlo), jnp.asarray(hhi))
    want_cur, want_lo, want_hi = vjp(jnp.asarray(g))
    before = tsk.weighted_step_sharded_bwd.launches
    gcur, (ghlo, ghhi) = tsk.weighted_step_sharded_bwd(
        torch.from_numpy(g), torch.from_numpy(code))
    assert tsk.weighted_step_sharded_bwd.launches == before
    _rel_close(gcur, want_cur)
    for got, want in ((ghlo, want_lo), (ghhi, want_hi)):
        assert got.shape == (1, 7, 9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=KERNEL_REL * float(np.abs(g).max()))


@pytest.mark.parametrize("n", [2, 3, 6])
def test_shards_equal_the_unsplit_step_to_the_bit(n):
    """With the neighbours' edge rows as halos the shards' B10 equals B8 on
    the whole grid to the bit; the shards' B11 plus the halo cotangents
    routed back to the neighbours' edge rows equals B9 within 1e-6 of peak
    (at an edge row the neighbour's term is added after the sum, not
    inside it)."""
    X, Y, Z = 6, 5, 11
    rng = np.random.default_rng(n)
    cur, prev, g = (torch.from_numpy(rng.normal(size=(X, Y, Z))
                                     .astype(np.float32)) for _ in range(3))
    code = torch.from_numpy(rng.integers(0, 1 << 13, size=(X, Y, Z))
                            .astype(np.int32))
    xl = X // n
    rows = [slice(s * xl, (s + 1) * xl) for s in range(n)]
    zero = torch.zeros(1, Y, Z)
    halos = [(cur[r.start - 1:r.start] if s else zero,
              cur[r.stop:r.stop + 1] if s < n - 1 else zero)
             for s, r in enumerate(rows)]
    fwd = torch.cat([tsk.weighted_step_sharded(cur[r], prev[r], code[r], h)
                     for r, h in zip(rows, halos)])
    assert torch.equal(fwd, tsk.weighted_step(cur, prev, code))
    parts = [tsk.weighted_step_sharded_bwd(g[r].contiguous(), code[r])
             for r in rows]
    bwd = torch.cat([p[0] for p in parts])
    for s, (_, (ghlo, ghhi)) in enumerate(parts):
        if s:
            bwd[rows[s].start - 1] += ghlo[0]
        if s < n - 1:
            bwd[rows[s].stop] += ghhi[0]
    want = tsk.weighted_step_bwd(g, code)
    np.testing.assert_allclose(bwd.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("xl", [1, 3])
def test_weighted_step_sharded_gradcheck(xl):
    """``torch.autograd.gradcheck`` of the Function in float64, in cur, prev
    and both halos."""
    cur, prev, code, hlo, hhi, _ = _shard_case(xl, 30 + xl, Y=4, Z=5)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (cur, prev, hlo, hhi)]
    c = torch.from_numpy(code)
    assert torch.autograd.gradcheck(
        lambda a, b, h0, h1: tsk.weighted_step_sharded(a, b, c, (h0, h1)),
        args)


# ---------------------------------------------------------------------------
# setup

@pytest.mark.parametrize("form", ["shoebox", "general"])
def test_compute_mesh_align_matches_reference(form):
    """``compute_mesh(…, align=(8, 1, 1))`` pads x as the reference's does:
    the same dims, inside mask, weight code and boundary tables."""
    ab = np.full((1, 8), 0.1)
    scene = dict(scene_box=jgeo.Box(*BOX)) if form == "shoebox" else {}
    jm = j_run.compute_mesh(jgeo.box_scene(jgeo.Box(*BOX)), ab, DX, FS,
                            align=(8, 1, 1), **scene)
    tscene = dict(scene_box=tgeo.Box(*BOX)) if form == "shoebox" else {}
    tm = t_run.compute_mesh(tgeo.box_scene(tgeo.Box(*BOX)), ab, DX, FS,
                            align=(8, 1, 1), device="cpu", **tscene)
    plain = t_run.compute_mesh(tgeo.box_scene(tgeo.Box(*BOX)), ab, DX, FS,
                               device="cpu", **tscene)
    dims = tm.descriptor.dimensions
    assert dims == tuple(jm.descriptor.dimensions)
    assert dims[0] % 8 == 0 and dims[0] > plain.descriptor.dimensions[0]
    assert dims[1:] == plain.descriptor.dimensions[1:]
    np.testing.assert_array_equal(tm.inside, np.asarray(jm.inside))
    for name in TABLES:
        np.testing.assert_array_equal(
            getattr(tm.structure, name).numpy(),
            np.asarray(getattr(jm.structure, name)), name)
    if form == "shoebox":
        assert tm.box_spec.dims == tuple(jm.box_spec.dims)
        assert tm.box_spec.ilo == tuple(jm.box_spec.ilo)
    else:
        assert tm.box_spec is None and jm.box_spec is None


@pytest.mark.parametrize("n", [2, 8])
def test_shard_general_tables_match(meshes, n):
    jm, tm = meshes
    dims = jm.descriptor.dimensions
    want = jgs.shard_general(jm.structure, dims, n)
    got = tgs.shard_general(tm.structure, dims, n)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      f.name)


def test_shard_general_needs_x_to_divide(meshes):
    _, tm = meshes
    X, Y, Z = tm.descriptor.dimensions
    with pytest.raises(ValueError, match="divisible"):
        tgs.shard_general(tm.structure, (X, Y, Z), 3)


# ---------------------------------------------------------------------------
# the sharded run

@pytest.fixture(scope="module")
def single_runs(meshes):
    jm, tm = meshes
    dims = jm.descriptor.dimensions
    jprob, tprob = _problem(jm)
    return (np.asarray(j_run.run_waveguide(jm.structure, dims, *jprob,
                                           STEPS)["outputs"]),
            t_run.run_waveguide(tm.structure, dims, *tprob,
                                STEPS)["outputs"])


@pytest.mark.parametrize("n", [2, 8])
def test_run_general_sharded_matches(meshes, single_runs, n):
    """``run_waveguide_general_sharded`` on ``["cpu"] * n``: equal to the
    port's single-device run, and within 5e-5 of the reference's sharded
    run on ``n`` virtual devices."""
    jm, tm = meshes
    dims = jm.descriptor.dimensions
    jprob, tprob = _problem(jm)
    want = jgs.run_waveguide_general_sharded(jps.make_device_mesh(n),
                                             jm.structure, dims, *jprob,
                                             STEPS)
    got = tgs.run_waveguide_general_sharded(cpu_mesh(n), tm.structure, dims,
                                            *tprob, STEPS)
    assert bool(got["stable"]) and bool(want["stable"])
    assert torch.equal(got["outputs"], single_runs[1])
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), rtol=0,
                               atol=RUN_ATOL)
    np.testing.assert_allclose(got["outputs"].numpy(), single_runs[0],
                               rtol=0, atol=RUN_ATOL)


def _grads(run, structure, source, receiver, steps, **kw):
    coef_b = structure.coef_b.detach().clone().requires_grad_(True)
    out = run(dataclasses.replace(structure, coef_b=coef_b), source,
              receiver, steps, **kw)
    torch.sum(out["outputs"] ** 2).backward()
    return coef_b.grad


def test_gradient_matches_single_and_jax_grad(meshes):
    """d(Σ taps²)/d coef_b through 4 CPU shards (B11's plain version in the
    backward, the halo cotangents routed back by autograd) against the
    port's single-device run and ``jax.grad`` of the reference's."""
    jm, tm = meshes
    dims = jm.descriptor.dimensions
    jprob, tprob = _problem(jm, 60)

    def loss_ref(coef_b):
        s = dataclasses.replace(jm.structure, coef_b=coef_b)
        return jnp.sum(j_run.run_waveguide(s, dims, *jprob,
                                           60)["outputs"] ** 2)

    want = np.asarray(jax.grad(loss_ref)(jm.structure.coef_b))
    mesh = cpu_mesh(4)
    g_sh = _grads(lambda s, *a, **k: tgs.run_waveguide_general_sharded(
        mesh, s, dims, *a, **k), tm.structure, *tprob, 60)
    g_si = _grads(lambda s, *a, **k: t_run.run_waveguide(s, dims, *a, **k),
                  tm.structure, *tprob, 60)
    g_ck = _grads(lambda s, *a, **k: tgs.run_waveguide_general_sharded(
        mesh, s, dims, *a, **k), tm.structure, *tprob, 60,
        checkpoint_every=16)
    assert float(np.abs(want).max()) > 0
    for got in (g_sh, g_ck):
        np.testing.assert_allclose(got.numpy(), g_si.numpy(), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)


def test_canonical_general_sharded_matches(meshes):
    """The hybrid engine's sharded waveguide leg on 8 CPU shards against the
    port's ``canonical`` and the reference's ``canonical_general_sharded``
    on 8 virtual devices."""
    jm, tm = meshes
    want = jgs.canonical_general_sharded(jm, (1.0, 1.2, 1.5),
                                         (1.0, 1.2, 2.3), 0.03,
                                         jps.make_device_mesh(8))
    single = t_run.canonical(tm, (1.0, 1.2, 1.5), (1.0, 1.2, 2.3), 0.03)
    got = tgs.canonical_general_sharded(tm, (1.0, 1.2, 1.5), (1.0, 1.2, 2.3),
                                        0.03, cpu_mesh(8))
    assert bool(got.stable) and got.sample_rate == single.sample_rate
    assert torch.equal(got.pressure, single.pressure)
    assert torch.equal(got.intensity, single.intensity)
    np.testing.assert_allclose(got.pressure.numpy(),
                               np.asarray(want.pressure), rtol=0,
                               atol=RUN_ATOL)
    np.testing.assert_allclose(got.intensity.numpy(),
                               np.asarray(want.intensity), rtol=0,
                               atol=RUN_ATOL)


def test_run_general_sharded_flags_nan(meshes):
    jm, tm = meshes
    _, (source, receiver) = _problem(jm, 8)
    sig = source.signal.clone()
    sig[3] = float("nan")
    out = tgs.run_waveguide_general_sharded(
        cpu_mesh(2), tm.structure, tm.descriptor.dimensions,
        dataclasses.replace(source, signal=sig), receiver, 8)
    assert not bool(out["stable"])


# ---------------------------------------------------------------------------
# the order of work of B11 and B9 (csrc/mesh_adjoint.cuh): warps of 32 (y, z)
# nodes, a bare path where every neighbour weighs exactly 1

@pytest.fixture(scope="module")
def columns_shard_code():
    """The second of four x-shards of the columns hall's weight code at a
    400 Hz cutoff, x aligned to 4 (as the card tests build it): walls,
    columns and a bare interior, (24, 41, 71)."""
    from wayverb_tpu_torch.tools.mesh_timing import columns_shard_code
    return columns_shard_code("cpu", cutoff=400.0)


def _loop_bare_warps(code):
    """B11's bare warps written out with numpy and loops: node n is bare
    when each neighbour n + e_d lies in the grid and its code's twelve
    weight bits are 0x3F (all six weights exactly 1); warp s of row x, the
    nodes p = 32·s … 32·s + 31 of the flattened (y, z) plane, is bare when
    all 32 exist and are bare."""
    c = code.numpy().astype(np.int64)
    X, Y, Z = c.shape
    one = np.pad((c & 0xFFF) == 0x3F, 1)      # False beyond the grid
    steps = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
             (0, 0, 1)]
    nwarps = -(-Y * Z // 32)
    want = np.zeros((X, nwarps), bool)
    for x in range(X):
        for s in range(nwarps):
            ok = True
            for p in range(32 * s, 32 * s + 32):
                y, z = divmod(p, Z)
                ok &= p < Y * Z and all(
                    one[1 + x + dx, 1 + y + dy, 1 + z + dz]
                    for dx, dy, dz in steps)
            want[x, s] = ok
    return torch.from_numpy(want)


def _kernel_order(g, code, halos=True):
    """B11 in plain torch, in the kernel's order: a node of a bare warp
    (``mesh_timing.bare_warps``) sums its six neighbours' g from +0 with no
    weight, every other node adds w_opp(dd)·g, dd = 0..5; then λ²·acc.  The
    halo rows (λ²·w)·g of rows 0 and X − 1.  With ``halos=False`` B9: ĝcur
    alone."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    X, Y, Z = g.shape
    general = torch.zeros_like(g)
    bare_sum = torch.zeros_like(g)
    for dd in range(6):
        gn = tsk._shifted(g, dd)
        general = general + tsk._shifted(
            tsk._weight(code, tsk._OPPOSITE[dd], g.dtype), dd) * gn
        bare_sum = bare_sum + gn
    node_bare = bare_warps(code)[:, torch.arange(Y * Z) // 32]
    gcur = tsk.COURANT_SQ * torch.where(node_bare.reshape(X, Y, Z),
                                        bare_sum, general)
    if not halos:
        return gcur
    ghlo = tsk.COURANT_SQ * tsk._weight(code[:1], 0, g.dtype) * g[:1]
    ghhi = tsk.COURANT_SQ * tsk._weight(code[-1:], 1, g.dtype) * g[-1:]
    return gcur, (ghlo, ghhi)


def _order_codes(shard):
    """(name, code): the columns hall's code (a shard, or the whole hall),
    slices of it (one and two rows, Y·Z < 32, odd Y), an interior block with a weight-2 and a weight-0
    neighbour in warps that would be bare without them (warp 9 of rows 4
    and 2), and random codes."""
    rng = np.random.default_rng(40)
    block = torch.full((6, 9, 70), 0x103F, dtype=torch.int32)
    block[3, 4, 20] |= 1 << 7          # weight 2 toward +x, (4, 4, 20)
    block[2, 5, 10] &= ~(1 << 2)       # weight 0 toward -y, (2, 4, 10)
    rand = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, 1 << 13, size=s).astype(np.int32))
    return [("columns code", shard), ("one row", shard[5:6].contiguous()),
            ("two rows", shard[5:7].contiguous()),
            ("odd Y", shard[:, :33].contiguous()),
            ("Y*Z < 32", shard[:4, 10:13, 30:35].contiguous()),
            ("interior block", block), ("random", rand(5, 37, 53)),
            ("random one row", rand(1, 7, 9))]


def test_adjoint_bare_warps_match_a_loop_classification(columns_shard_code):
    """``mesh_timing.bare_warps`` against the classification written out
    with loops, on the real shard, its slices and synthetic codes; the
    shard has bare and general warps."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    for name, code in _order_codes(columns_shard_code):
        assert torch.equal(bare_warps(code), _loop_bare_warps(code)), name
    share = float(bare_warps(columns_shard_code).float().mean())
    assert 0.05 < share < 0.95


def _order_gs(rng, shape):
    """(name, g): random, at 1e38 with ±inf and NaN (sums that overflow,
    0·inf at weight-0 neighbours), and all −0, drawn with numpy."""
    with np.errstate(over="ignore"):
        big = rng.normal(size=shape).astype(np.float32) * np.float32(1e38)
    flat = big.reshape(-1)
    flat[::7], flat[::11], flat[::13] = np.inf, -np.inf, np.nan
    return [("random", rng.normal(size=shape).astype(np.float32)),
            ("1e38 inf nan", big), ("-0", np.full(shape, -0.0, np.float32))]


def test_adjoint_kernel_order_equals_plain_to_the_bit(columns_shard_code):
    """The kernel's order and bare classification (``_kernel_order``) equal
    ``_weighted_step_sharded_bwd_plain`` to the bit (NaN for NaN, −0 apart
    from +0): random g, g at 1e38 with ±inf and NaN, and all −0; on every
    code of ``_order_codes``."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    rng = np.random.default_rng(41)
    for name, code in _order_codes(columns_shard_code):
        for what, g in _order_gs(rng, tuple(code.shape)):
            g = torch.from_numpy(g)
            want = tsk._weighted_step_sharded_bwd_plain(g, code)
            got = _kernel_order(g, code)
            for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
                assert bits_equal(a, b), (name, what)


@pytest.fixture(scope="module")
def columns_code():
    """The columns hall's whole weight code at a 400 Hz cutoff, no x
    alignment (as the card tests build it for B9)."""
    from wayverb_tpu_torch.tools.mesh_timing import columns_code
    return columns_code("cpu", cutoff=400.0)


def test_unsharded_adjoint_kernel_order_equals_plain_to_the_bit(
        columns_code):
    """B9 runs B11's walk without halo outputs: its order and bare
    classification (``_kernel_order(halos=False)``) equal
    ``_weighted_step_bwd_plain`` to the bit on the whole hall's code (bare
    and general warps, g at the grid's ends taken as 0 as beyond a shard),
    its slices, synthetic and random codes; random g, g at 1e38 with ±inf
    and NaN, and all −0."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps, bits_equal
    warps = bare_warps(columns_code)
    assert 0 < int(warps.sum()) < warps.numel()
    rng = np.random.default_rng(42)
    for name, code in _order_codes(columns_code):
        for what, g in _order_gs(rng, tuple(code.shape)):
            g = torch.from_numpy(g)
            got = _kernel_order(g, code, halos=False)
            assert bits_equal(got, tsk._weighted_step_bwd_plain(g, code)), \
                (name, what)
