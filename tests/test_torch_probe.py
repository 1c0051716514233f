"""The port's residency probe against the reference probe, on the CPU.

``tools/bench/probe_vmem_resident.py`` is not in a package; it is loaded by
its file path, and its ``_kernel`` runs through a ``pl.pallas_call`` built
here with the reference's specs and ``interpret=True``.  The port's plain
version (``chunk_plain``) must agree with it within 1e-5 of the peak: XLA
contracts ``C2 * acc - dst`` into an FMA where the port rounds twice
(ROADMAP §C).  Where the reference is not the oracle (X not a multiple of 8,
odd K) a float64 numpy leapfrog is.  The CUDA kernel is held against the
plain version on a GPU, in ``tests/test_torch_kernels.py``.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wayverb_tpu_torch.tools import probe_resident as pr

REL = 1e-5
H100 = pr.Capacity(sms=132, smem_per_cta=232448, l2_bytes=50 * 2 ** 20,
                   clusters=pr.H100_CLUSTERS)
REF_PATH = Path(__file__).resolve().parents[1] / "tools" / "bench" \
    / "probe_vmem_resident.py"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("probe_vmem_resident",
                                                  REF_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ref_call(ref, X, Y, Z, K):
    """The reference's ``pallas_call`` of ``_kernel`` (its ``make_run``),
    interpreted on the CPU."""
    return pl.pallas_call(
        functools.partial(ref._kernel, X=X, Y=Y, Z=Z, K=K),
        out_shape=(jax.ShapeDtypeStruct((X, Y, Z), jnp.float32),
                   jax.ShapeDtypeStruct((X, Y, Z), jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=(pl.BlockSpec(memory_space=pltpu.ANY),
                   pl.BlockSpec(memory_space=pltpu.ANY)),
        scratch_shapes=[pltpu.VMEM((X, Y, Z), jnp.float32),
                        pltpu.VMEM((X, Y, Z), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        input_output_aliases={0: 0, 1: 1},
        interpret=True)


def _fields(dims, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(dims).astype(np.float32),
            rng.standard_normal(dims).astype(np.float32))


def _oracle(cur, prev, K):
    """K sub-steps of the bare leapfrog in float64 numpy, every plane."""
    a, b = cur.astype(np.float64), prev.astype(np.float64)
    for s in range(K):
        src = a if s % 2 == 0 else b
        p = np.pad(src, 1)
        acc = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1]
               + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
        if s % 2 == 0:
            b = acc / 3.0 - b
        else:
            a = acc / 3.0 - a
    return (b, a) if K % 2 else (a, b)


def _port(cur, prev, K):
    a, b = pr.chunk_plain(torch.from_numpy(cur), torch.from_numpy(prev), K)
    return a.numpy(), b.numpy()


def _within(got, want, rel=REL):
    peak = float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= rel * peak


@pytest.mark.parametrize("dims,K", [((16, 8, 12), 6), ((8, 5, 7), 2)])
def test_chunk_plain_matches_reference_kernel(ref, dims, K):
    cur, prev = _fields(dims, 0)
    want = _ref_call(ref, *dims, K)(jnp.asarray(cur), jnp.asarray(prev))
    got = _port(cur, prev, K)
    for g, w in zip(got, want):
        assert _within(g, np.asarray(w))


def test_make_run_scalar_matches_reference_scan(ref):
    """The reference's ``run``: a ``scan`` of launches, then Σ cur[8, 8,
    :8]; the port's ``make_run`` on the CPU."""
    X, Y, Z, K, nchunks = 16, 9, 12, 2, 3
    cur, prev = _fields((X, Y, Z), 1)
    call = _ref_call(ref, X, Y, Z, K)

    def body(c, _):
        return call(*c), 0.0

    (jc, _), _ = jax.lax.scan(body, (jnp.asarray(cur), jnp.asarray(prev)),
                              jnp.arange(nchunks))
    want = float(jnp.sum(jc[8, 8, :8]))
    run = pr.make_run(X, Y, Z, K, device="cpu")
    got = run(torch.from_numpy(cur), torch.from_numpy(prev), nchunks)
    assert got.shape == () and got.device.type == "cpu"
    field, _ = _port(cur, prev, K * nchunks)
    assert abs(float(got) - want) <= REL * float(np.abs(field).max())
    with pytest.raises(ValueError):
        run(torch.from_numpy(cur[:8]), torch.from_numpy(prev[:8]), 1)


@pytest.mark.parametrize("dims,K", [((12, 8, 12), 5), ((12, 8, 12), 6),
                                    (pr.T30_DIMS, 7), (pr.T30_DIMS, 2)])
def test_port_matches_float64_oracle_at_any_x_and_k(dims, K):
    """X % 8 != 0 and odd K, where the reference is not the oracle."""
    cur, prev = _fields(dims, 2)
    for g, w in zip(_port(cur, prev, K), _oracle(cur, prev, K)):
        assert _within(g, w)


def test_reference_leaves_the_planes_past_its_last_slab_unchanged(ref):
    """At X = 12 the reference's slab loop runs once: planes 8-11 keep
    their inputs (and planes 6-7 read a stale x+ neighbour); the port
    updates every plane, as the float64 oracle does."""
    cur, prev = _fields((12, 8, 12), 3)
    ra, rb = (np.asarray(t) for t in _ref_call(ref, 12, 8, 12, 2)(
        jnp.asarray(cur), jnp.asarray(prev)))
    assert np.array_equal(ra[8:], cur[8:]) and np.array_equal(rb[8:],
                                                              prev[8:])
    oa, ob = _oracle(cur, prev, 2)
    assert not _within(ra, oa)
    pa, pb = _port(cur, prev, 2)
    assert _within(pa, oa) and _within(pb, ob)
    assert not np.array_equal(pa[8:], cur[8:])


def test_reference_runs_k_minus_one_substeps_for_odd_k(ref):
    cur, prev = _fields((8, 5, 7), 4)
    args = (jnp.asarray(cur), jnp.asarray(prev))
    three = _ref_call(ref, 8, 5, 7, 3)(*args)
    two = _ref_call(ref, 8, 5, 7, 2)(*args)
    for a, b in zip(three, two):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for g, w in zip(_port(cur, prev, 3), _oracle(cur, prev, 3)):
        assert _within(g, w)


def test_plan_tiles_with_the_h100_numbers():
    t30 = pr.plan_tiles(pr.T30_DIMS, H100)
    assert (t30.fits, t30.tile, t30.tiles, t30.bytes_per_cta) == (
        True, (1, 19, 21), 15, 3192)
    assert (t30.one_cluster, t30.cluster, t30.threads) == (True, 15, 416)
    worked = pr.plan_tiles((64, 224, 256), H100)
    assert (worked.tile, worked.tiles, worked.bytes_per_cta) == (
        (8, 14, 256), 128, 229376)
    # 16 clusters of 8 are not resident at once (15 are), 64 of 2 are
    assert (worked.cluster, worked.threads, worked.one_cluster) == (
        2, 896, False)
    assert H100.smem_per_cta - worked.bytes_per_cta == 3072
    half = pr.plan_tiles((32, 224, 256), H100)
    assert (half.tile, half.tiles, half.cluster) == ((8, 7, 256), 128, 2)
    hall = pr.plan_tiles((224, 224, 256), H100)
    assert not hall.fits
    assert (hall.bytes_needed, hall.bytes_available) == (102760448,
                                                         30683136)
    assert "102760448" in hall.describe() and "30683136" in hall.describe()
    assert not pr.plan_tiles((96, 224, 256), H100).fits     # 44 MB
    # a given tile: one over a CTA's share, one that takes too many CTAs
    assert not pr.plan_tiles((64, 224, 256), H100, (8, 16, 256)).fits
    assert not pr.plan_tiles((64, 224, 256), H100, (1, 14, 256)).fits
    assert pr.plan_tiles((12, 9, 7), H100, (5, 4, 3)).tiles == 27
    with pytest.raises(ValueError):
        pr.plan_tiles((12, 9, 7), H100, (13, 4, 3))


@pytest.mark.parametrize("clusters,want", [
    (pr.H100_CLUSTERS, 2),                   # 15 clusters of 8 resident
    (((2, 66), (4, 32), (8, 16)), 8),        # a card that holds 16 of 8
    (((2, 66), (4, 32)), 4),
    ((), 1)])                                # no cluster figures
def test_plan_tiles_takes_the_largest_cluster_that_is_resident(clusters,
                                                               want):
    """The worked placement's 8 x tiles go in the largest cluster that
    divides them and whose 128 / size clusters are resident at once."""
    cap = dataclasses.replace(H100, clusters=clusters)
    p = pr.plan_tiles((64, 224, 256), cap, (8, 14, 256))
    assert (p.fits, p.cluster, p.one_cluster) == (True, want, False)
    # x faces inside a cluster are read from its shared memory, the rest
    # (y faces and x faces between clusters) through device memory
    x_face, y_face = 14 * 256, 8 * 256
    fx = {1: 2, 2: 1, 4: 1, 8: 0}[want]
    assert p.buffered == fx * x_face + 2 * y_face
    assert p.cost == pr.tile_cost((8, 14, 256), 2 * y_face) \
        == 8 * 14 * 256 + 3 * 14 * 256 + 2 * 2 * y_face


def test_plan_tiles_worked_placement_counts_39_percent_exchanged():
    """Without clusters the worked tile writes and reads 11,264 of its
    28,672 nodes through device memory a sub-step (39 %)."""
    p = pr.plan_tiles((64, 224, 256), dataclasses.replace(H100, clusters=()))
    assert (p.tile, p.cluster, p.buffered) == ((8, 14, 256), 1, 11264)
    assert round(p.buffered / (8 * 14 * 256), 2) == 0.39


@pytest.mark.parametrize("dims,tile,tiles,cluster", [
    (pr.T30_DIMS, None, 15, 15), ((12, 9, 7), None, 12, 12),
    ((9, 10, 8), None, 9, 9), ((12, 9, 7), (12, 9, 7), 1, 1),
    ((30, 20, 50), (3, 20, 50), 10, 10)])
def test_a_grid_that_fits_one_cluster_goes_on_one(dims, tile, tiles,
                                                  cluster):
    """One cluster along x, whole y and z, in as many tiles as it can: no
    grid barrier and nothing through device memory."""
    p = pr.plan_tiles(dims, H100, tile)
    assert (p.one_cluster, p.tiles, p.cluster) == (True, tiles, cluster)
    assert p.buffered == 0 and p.tile[1:] == dims[1:]
    assert "one cluster" in p.describe()


@pytest.mark.parametrize("dims,tile,cluster,buffered", [
    ((24, 10, 40), (2, 5, 20), 12, 2 * 20 + 2 * 5),
    ((24, 10, 40), (1, 10, 40), 12, 10 * 40),        # two clusters along x
    ((24, 10, 40), (1, 5, 20), 8, 5 * 20 + 20 + 5),
    ((16, 12, 40), (4, 6, 20), 4, 80 + 24),
    ((64, 224, 256), (8, 28, 128), 2, 28 * 128 + 2 * 8 * 128 + 8 * 28),
    ((32, 224, 256), (4, 14, 256), 2, 14 * 256 + 2 * 4 * 256)])
def test_given_tiles_cut_each_axis(dims, tile, cluster, buffered):
    p = pr.plan_tiles(dims, H100, tile)
    assert (p.fits, p.one_cluster, p.cluster) == (True, False, cluster)
    assert p.buffered == buffered


def test_a_grid_whose_clusters_are_not_resident_is_refused():
    """128 tiles whose only cluster is 1 fit; 136 do not (132 SMs), and a
    card that holds fewer clusters than the tiling needs refuses it."""
    assert not pr.plan_tiles((64, 238, 256), H100, (8, 14, 256)).fits
    few = dataclasses.replace(H100, sms=64)
    assert not pr.plan_tiles((64, 224, 256), few).fits


def test_tile_cost_prefers_longer_walks_and_fewer_faces():
    """The planner's estimate orders the z-spanning tiles timed on the H100
    as they ran (PERF.md §6, PR 22): at (32, 224, 256) (8, 7, 256) <
    (4, 14, 256) < (4, 15, 256), at (64, 224, 256) (8, 14, 256) <
    (16, 7, 256)."""
    def cost(dims, tile):
        return pr.plan_tiles(dims, H100, tile).cost
    half, worked = (32, 224, 256), (64, 224, 256)
    assert cost(half, (8, 7, 256)) < cost(half, (4, 14, 256)) \
        < cost(half, (4, 15, 256))
    assert cost(worked, (8, 14, 256)) < cost(worked, (16, 7, 256))


@pytest.mark.parametrize("dims,most,ctas", [
    ((224, 224, 256), 792, 784), ((32, 224, 256), 792, 598),
    (pr.T30_DIMS, 792, 8), ((4, 8, 32), 792, 1)])
def test_streamed_grid_takes_its_items_in_as_few_rounds(dims, most, ctas):
    """The device-memory grid: (plane blocks of 256 nodes) x (row blocks
    of 4) items over at most ``most`` CTAs, as few as keep the rounds."""
    assert pr.streamed_ctas(dims, most) == ctas


def test_streamed_grid_refuses_a_plane_of_2_31_nodes():
    """The device-memory kernel's (y, z) plane indices are 32-bit; its node
    index is 64-bit from 2^31 nodes on, so only the plane is limited."""
    assert pr._wide((2 ** 31 // (224 * 256) + 1, 224, 256))
    assert not pr._wide((224, 224, 256))
    assert pr.streamed_ctas((2 ** 20, 2 ** 10, 2 ** 10), 792) == 792
    with pytest.raises(ValueError, match="2\\^31"):
        pr.streamed_ctas((1, 2 ** 16, 2 ** 15), 792)


@pytest.mark.parametrize("columns,threads", [
    (3584, 896), (399, 416), (1024, 1024), (1025, 544), (1, 32),
    (3840, 960)])
def test_threads_make_the_passes_even(columns, threads):
    assert pr._threads(columns) == threads


def test_resident_capacity_needs_numbers_off_the_card():
    assert pr.resident_capacity("cpu", sms=132, smem_per_cta=232448,
                                l2_bytes=50 * 2 ** 20,
                                clusters=pr.H100_CLUSTERS) == H100
    with pytest.raises(ValueError):
        pr.resident_capacity("cpu")


def test_bounds_of_the_hall():
    n = 224 * 224 * 256
    us, by = pr.bound_us((224, 224, 256), 64, True)
    assert by == "operations" and us == pytest.approx(7 * n / 67e6)
    assert round(us, 2) == 1.34
    us, by = pr.bound_us((224, 224, 256), 64, False)
    assert by == "bytes" and round(us, 1) == 46.0
    assert pr.bound_us((224, 224, 256), 1, True)[1] == "bytes"


@pytest.mark.parametrize("resident", [True, False])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(resident):
    cur, prev = (torch.from_numpy(f) for f in _fields((12, 9, 7), 5))
    before = pr.resident_chunk.launches
    got = pr.resident_chunk(cur, prev, 5, resident=resident)
    assert pr.resident_chunk.launches == before
    for g, w in zip(got, pr.chunk_plain(cur, prev, 5)):
        assert torch.equal(g, w)
    assert torch.equal(cur, torch.from_numpy(_fields((12, 9, 7), 5)[0]))


def test_resident_chunk_rejects_what_the_kernel_cannot_take():
    cur, prev = (torch.from_numpy(f) for f in _fields((12, 9, 7), 6))
    for bad in ((cur.double(), prev.double(), 2), (cur, prev[:6], 2),
                (cur.transpose(0, 2), prev.transpose(0, 2), 2),
                (cur, prev, 0), (cur, prev, 2.0)):
        with pytest.raises(ValueError):
            pr.resident_chunk(*bad)
    with pytest.raises(ValueError):
        pr.resident_chunk(cur.to("meta"), prev.to("meta"), 2)
