"""Probe: K bare leapfrog sub-steps with both fields held on chip.

Port of ``tools/bench/probe_vmem_resident.py`` (the TPU probe that became the
mega chunk kernel): per node and sub-step

    dst = C2 · (((((x− + x+) + y−) + y+) + z−) + z+) − dst,    C2 = 1/3,

the sum over ``src``, zero beyond the grid, ``src`` and ``dst`` swapping
roles every sub-step.  No boundary filters, no source, no taps.

On the TPU one core holds both fields of a (224, 224, 256) grid in VMEM.  On
the H100 the on-chip store is shared memory, at most 232,448 B a CTA, which a
CTA of a thread-block cluster can also read in its cluster neighbours, so
``resident_chunk`` launches the hand-written kernel ``csrc/probe_resident.cu``
once per call, every thread walking x down a (y, z) column, in one of two
modes:

* ``resident=True``: each CTA holds one tile of both fields in shared memory
  for all K sub-steps, its tiles grouped into clusters along x whose x faces
  pass through distributed shared memory.  ``plan_tiles`` places them: a
  grid that fits one cluster runs on it with a cluster barrier between
  sub-steps; a larger one runs as a cooperative grid of clusters with a grid
  barrier, its other faces through a face buffer in device memory.  A grid
  it cannot place raises ``ValueError`` before any launch;
* ``resident=False``: a persistent cooperative grid and its barrier, the
  fields in device memory (and L2 while they fit it).

CPU tensors run the plain version ``chunk_plain``; CUDA tensors launch the
kernel or raise.  Launches are counted in ``resident_chunk.launches``.

The reference updates only the first ``X − X % 8`` planes (its slab loop runs
``X // 8`` times) and runs ``K − 1`` sub-steps for odd K; the port updates
every plane and runs exactly K sub-steps (ROADMAP §C).

    python -m wayverb_tpu_torch.tools.probe_resident [--step0]

runs the sweep on the card (``main``): one JSON line per (shape, mode, K);
``--step0`` instead prints what the design rests on (``step0``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time

import torch

from wayverb_tpu_torch.tools import roofline

C2 = 1.0 / 3.0
BYTES_PER_NODE = 8             # both float32 fields
OPS_PER_NODE = 7               # 5 adds, a multiply, a subtract a sub-step
# shared memory a resident node moves a sub-step: src at x + 1, the four y
# and z neighbours and dst read, dst written (x - 1 and x in registers)
SMEM_BYTES_PER_NODE = 28
SMEM_BYTES_PER_CLOCK = 128     # one SM's shared memory

# the sweep: the reference's shapes, two that fit shared memory, one under
# the 50 MB L2, and the T30 box's grid (tests/test_waveguide.py:155-167)
T30_DIMS = (15, 19, 21)
SWEEP_SHAPES = ((128, 224, 256), (192, 224, 256), (224, 224, 256),
                (64, 224, 256), (32, 224, 256), (96, 224, 256), T30_DIMS)
SWEEP_KS = (1, 8, 64)


# ---------------------------------------------------------------------------
# the plain version

def _shift(field, axis: int, step: int):
    """field[i + step] along ``axis`` (step ±1), zero beyond the grid."""
    zero = torch.zeros_like(field.narrow(axis, 0, 1))
    n = field.shape[axis]
    if step == 1:
        return torch.cat([field.narrow(axis, 1, n - 1), zero], dim=axis)
    return torch.cat([zero, field.narrow(axis, 0, n - 1)], dim=axis)


def substep_plain(dst, src):
    """One sub-step: C2 · Σ₆ src − dst in the reference's order of
    additions, each operation rounded on its own; returns the new dst."""
    acc = _shift(src, 0, -1) + _shift(src, 0, 1)
    acc = acc + _shift(src, 1, -1)
    acc = acc + _shift(src, 1, 1)
    acc = acc + _shift(src, 2, -1)
    acc = acc + _shift(src, 2, 1)
    return C2 * acc - dst


def chunk_plain(cur, prev, K: int):
    """K sub-steps from (cur, prev); returns (newest, the one before)."""
    a, b = cur, prev
    for s in range(K):
        if s % 2 == 0:
            b = substep_plain(b, a)
        else:
            a = substep_plain(a, b)
    return (b, a) if K % 2 else (a, b)


# ---------------------------------------------------------------------------
# placing a resident run

@dataclasses.dataclass(frozen=True)
class Capacity:
    """What a resident run may use: SMs (one CTA each), the shared memory a
    CTA may opt in to, the L2 size in bytes, and ``clusters``: (cluster
    size, clusters of that many CTAs of 1,024 threads and a full share of
    shared memory resident at once) for the sizes a launch may use, none
    when empty (every CTA its own cluster)."""
    sms: int
    smem_per_cta: int
    l2_bytes: int
    clusters: tuple = ()

    def clusters_at_once(self, size: int) -> int:
        if size == 1:
            return self.sms
        return dict(self.clusters).get(size, 0)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A resident run's tiling: ``tile`` (tx, ty, tz) and ``tiles`` CTAs of
    ``threads`` threads and ``bytes_per_cta`` shared memory, in clusters of
    ``cluster`` CTAs along x, or ``tile`` None when the grid cannot be
    placed.  ``cost`` estimates the busiest tile's work a sub-step in
    nodes (``tile_cost``), ``buffered`` counts the face nodes of that tile
    that pass through device memory.
    ``bytes_needed`` is both fields, ``bytes_available`` the shared memory
    of all SMs."""
    dims: tuple
    tile: tuple | None
    tiles: int
    bytes_per_cta: int
    bytes_needed: int
    bytes_available: int
    cluster: int = 1
    threads: int = 0
    cost: int = 0
    buffered: int = 0

    @property
    def fits(self) -> bool:
        return self.tile is not None

    @property
    def one_cluster(self) -> bool:
        """The whole grid in one cluster: no grid barrier, no face buffer."""
        return self.fits and self.tiles == self.cluster

    def describe(self) -> str:
        if self.fits:
            form = "one cluster" if self.one_cluster else \
                f"{self.tiles // self.cluster} clusters of {self.cluster}"
            return (f"{self.tiles} tiles of {self.tile}, {self.bytes_per_cta} "
                    f"B and {self.threads} threads each, {form}")
        return (f"grid {self.dims} needs {self.bytes_needed} B of shared "
                f"memory for both fields; the card holds "
                f"{self.bytes_available} B")


CLUSTER_SIZES = tuple(range(1, 17))


@functools.cache
def _device_capacity(index: int) -> Capacity:
    lib = _kernel_lib()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        err = lib.wv_probe_device_attrs(index, out)
        if err != 0:
            raise RuntimeError("probe_resident: reading the device's "
                               "attributes failed: "
                               + lib.wv_cuda_error_string(err).decode())
        sms, smem, l2 = out
        clusters = tuple((c, _occupancy(1, c, 1024, smem)["clusters"])
                         for c in CLUSTER_SIZES[1:])
    return Capacity(sms, smem, l2, clusters)


def resident_capacity(device="cuda", *, sms=None, smem_per_cta=None,
                      l2_bytes=None, clusters=()) -> Capacity:
    """The card's SM count, ``cudaDevAttrMaxSharedMemoryPerBlockOptin``, L2
    size and the clusters of 2..16 CTAs resident at once, read from the
    CUDA device.  For any other device (the CPU) the numbers are given:
    ``resident_capacity("cpu", sms=132, smem_per_cta=232448, l2_bytes=50 *
    2**20, clusters=H100_CLUSTERS)`` is the H100 SXM."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return _device_capacity(index)
    if None in (sms, smem_per_cta, l2_bytes):
        raise ValueError("resident_capacity: give sms, smem_per_cta and "
                         f"l2_bytes for a {device.type} device")
    return Capacity(sms, smem_per_cta, l2_bytes, tuple(clusters))


# clusters of 1,024-thread CTAs with 232,448 B each (the most a CTA may
# opt in to) resident at once on the NVIDIA H100 80GB HBM3, sizes 2..16
# (``Capacity.clusters`` read on the card; step 0, PERF.md §6 PR 22)
H100_CLUSTERS = ((2, 66), (3, 39), (4, 30), (5, 22), (6, 17), (7, 15),
                 (8, 15), (9, 9), (10, 7), (11, 7), (12, 7), (13, 7),
                 (14, 7), (15, 7), (16, 7))


def _lengths(n: int):
    """The distinct tile lengths ceil(n / k) for k = 1..n."""
    return sorted({-(-n // k) for k in range(1, n + 1)}, reverse=True)


def _threads(columns: int) -> int:
    """Warps enough for the tile's (y, z) columns in as few passes as 1,024
    threads take, no more: 3,584 columns take 4 passes of 896."""
    passes = -(-columns // 1024)
    return 32 * -(-columns // (32 * passes))


# the weights of ``tile_cost``: a (y, z) column's walk (its start and its
# two x ends' loads) and a y or z face node through device memory, in
# nodes; fitted to the tile variants timed on the H100 (PERF.md §6, PR 22)
COLUMN_COST = 3
FACE_COST = 2


def tile_cost(tile, yz_buffered: int) -> int:
    """The busiest tile's work a sub-step, in nodes: each node, each (y, z)
    column's walk, and each y or z face node that passes through device
    memory.  At equal nodes, longer walks and fewer such faces win."""
    tx, ty, tz = tile
    return tx * ty * tz + COLUMN_COST * ty * tz + FACE_COST * yz_buffered


def _placement(dims, tile, capacity: Capacity) -> Placement:
    """The tile in the largest cluster along x that divides the x tiles
    and whose clusters are resident at once."""
    X, Y, Z = dims
    tx, ty, tz = tile
    nx, ny, nz = -(-X // tx), -(-Y // ty), -(-Z // tz)
    tiles = nx * ny * nz
    per = BYTES_PER_NODE * tx * ty * tz
    unfit = Placement(tuple(dims), None, tiles, per,
                      BYTES_PER_NODE * X * Y * Z,
                      capacity.sms * capacity.smem_per_cta)
    if per > capacity.smem_per_cta or tiles > capacity.sms:
        return unfit
    fitting = [c for c in CLUSTER_SIZES if nx % c == 0
               and tiles // c <= capacity.clusters_at_once(c)]
    if not fitting:
        return unfit
    c = max(fitting)
    # faces of the busiest tile: x faces inside a cluster are read from the
    # neighbour's shared memory, every other face through device memory
    fx = 0 if nx == c else min(2, nx - 1) if c == 1 else 1
    yz = min(2, ny - 1) * tx * tz + min(2, nz - 1) * tx * ty
    return dataclasses.replace(
        unfit, tile=tuple(tile), cluster=c, threads=_threads(ty * tz),
        cost=tile_cost(tile, yz), buffered=fx * ty * tz + yz)


def plan_tiles(dims, capacity: Capacity, tile=None) -> Placement:
    """Where a resident run of ``dims`` goes, one CTA a tile, at most one
    per SM, both fields of a tile in its CTA's shared memory, tiles in
    clusters along x (the largest cluster that divides the x tiles and
    whose clusters are resident at once).  A grid that fits one cluster
    goes on one, in as many tiles as it can (whole y and z); any other on
    a cooperative grid, preferring tiles that span z (whole rows), then
    the least ``cost`` of the busiest tile, then more tiles: at equal
    cost, more SMs busy.  ``tile`` checks a given (tx, ty, tz) instead.
    The result's ``fits`` is False when nothing fits."""
    X, Y, Z = (int(d) for d in dims)
    if min(X, Y, Z) < 1:
        raise ValueError(f"plan_tiles: empty grid {dims}")
    if tile is not None:
        if len(tile) != 3 or not all(1 <= t <= d for t, d in
                                     zip(tile, (X, Y, Z))):
            raise ValueError(f"plan_tiles: tile {tile} does not fit in "
                             f"grid {dims}")
        return _placement((X, Y, Z), tuple(int(t) for t in tile), capacity)
    best = None
    for tz in _lengths(Z):
        for ty in _lengths(Y):
            if BYTES_PER_NODE * ty * tz > capacity.smem_per_cta:
                continue
            for tx in _lengths(X):
                p = _placement((X, Y, Z), (tx, ty, tz), capacity)
                if not p.fits:
                    continue
                key = (not p.one_cluster, tz != Z,
                       p.cost if not p.one_cluster else 0, -p.tiles, -tx)
                if best is None or key < best[0]:
                    best = (key, p)
    if best is not None:
        return best[1]
    return Placement((X, Y, Z), None, 0, 0, BYTES_PER_NODE * X * Y * Z,
                     capacity.sms * capacity.smem_per_cta)


# the search takes milliseconds, far longer than a launch, so the wrapper
# asks it once per (dims, capacity, tile)
_cached_plan = functools.lru_cache(maxsize=256)(plan_tiles)


# ---------------------------------------------------------------------------
# launching

@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("probe_resident")
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.wv_probe_resident_f32.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.wv_probe_resident_f32.restype = ctypes.c_int
    lib.wv_probe_resident_occupancy.argtypes = [i] * 4 + [ip] * 4
    lib.wv_probe_resident_occupancy.restype = ctypes.c_int
    lib.wv_probe_device_attrs.argtypes = [i, ip]
    lib.wv_probe_device_attrs.restype = ctypes.c_int
    lib.wv_probe_barrier.argtypes = [i] * 6 + [p]
    lib.wv_probe_barrier.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _occupancy(form: int, cluster: int, threads: int, smem: int) -> dict:
    lib = _kernel_lib()
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.wv_probe_resident_occupancy(form, cluster, threads, smem,
                                          *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError("probe_resident occupancy query failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "clusters"),
                    (x.value for x in out)))


STREAM_THREADS = 256   # the device-memory kernel's CTA: kStreamThreads
STREAM_WALK = 4        # x rows a thread walks: kStreamWalk


def streamed_ctas(dims, most: int) -> int:
    """The device-memory launch's CTAs, which the wrapper passes to the C
    entry point: at most ``most`` (the CTAs resident at once), as few as
    take its (plane block, row block) items in as few rounds.  The
    kernel's (y, z) plane indices are 32-bit: a plane of 2^31 nodes or
    more raises ``ValueError``."""
    X, Y, Z = dims
    if Y * Z >= 2 ** 31:
        raise ValueError("resident_chunk: the device-memory form takes a "
                         f"(y, z) plane of fewer than 2^31 nodes, got {Y * Z}")
    items = -(-Y * Z // STREAM_THREADS) * -(-X // STREAM_WALK)
    rounds = -(-items // most)
    return -(-items // rounds)


def _wide(dims) -> bool:
    """Whether the device-memory kernel needs its 64-bit node index."""
    return math.prod(dims) >= 2 ** 31


@functools.cache
def _streamed_most(index: int, wide: bool) -> int:
    """The device-memory kernel's CTAs resident at once on the card."""
    with torch.cuda.device(index):
        return _occupancy(3 if wide else 0, 1, 0, 0)["ctas_per_sm"] \
            * _device_capacity(index).sms


def occupancy(dims=(64, 224, 256), resident: bool = True,
              device="cuda") -> dict:
    """What the card makes of P1's launch at ``dims``: registers a thread,
    local memory (spills) a thread in bytes, CTAs resident on one SM and
    ``form`` ("one cluster", "grid" or "device memory"); resident also the
    placement's cluster size, threads a CTA, tiles and the clusters of that
    size resident at once, in device memory the node index's bits (64 from
    2^31 nodes on).  The CTAs a launch used are in
    ``resident_chunk.last_grid``."""
    with torch.cuda.device(torch.device(device)):
        capacity = resident_capacity(device)
        if not resident:
            return {**_occupancy(3 if _wide(dims) else 0, 1, 0, 0),
                    "form": "device memory", "cluster": None,
                    "index_bits": 64 if _wide(dims) else 32}
        place = _cached_plan(tuple(dims), capacity, None)
        if not place.fits:
            raise ValueError("probe_resident: " + place.describe())
        occ = _occupancy(2 if place.one_cluster else 1, place.cluster,
                         place.threads, place.bytes_per_cta)
    return {**occ, "form": "one cluster" if place.one_cluster else "grid",
            "cluster": place.cluster, "threads": place.threads,
            "tiles": place.tiles, "tile": list(place.tile)}


def _check_fields(cur, prev, K):
    for name, t in (("cur", cur), ("prev", prev)):
        if t.dim() != 3 or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != cur.shape \
                or t.device != cur.device:
            raise ValueError(
                f"resident_chunk: {name} must be a contiguous float32 "
                f"(X, Y, Z) tensor of cur's shape {tuple(cur.shape)} on "
                f"{cur.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if isinstance(K, bool) or not isinstance(K, int) or K < 1:
        raise ValueError(f"resident_chunk: K must be an int >= 1, got {K!r}")


def resident_chunk(cur, prev, K: int, *, resident: bool = True, tile=None):
    """K leapfrog sub-steps from (cur, prev); returns the new (cur, prev):
    the newest field and the one before it.  The inputs are not changed.

    CPU tensors run ``chunk_plain``.  CUDA tensors launch the kernel once
    (counted in ``resident_chunk.launches``, its CTAs, threads a CTA and
    cluster size in ``resident_chunk.last_grid``) or raise:
    ``resident=True`` holds the fields in shared memory, in the tiling
    ``plan_tiles`` gives (or the given ``tile``), and raises ``ValueError``
    before any launch when the grid cannot be placed; ``resident=False``
    keeps them in device memory, on the grid ``streamed_ctas`` sizes, with
    a 64-bit node index from 2^31 nodes on.
    """
    _check_fields(cur, prev, K)
    if cur.device.type == "cpu":
        return chunk_plain(cur, prev, K)
    if not cur.is_cuda:
        raise ValueError(f"resident_chunk: no kernel for device {cur.device}")
    X, Y, Z = cur.shape
    if resident:
        place = _cached_plan(tuple(cur.shape), resident_capacity(cur.device),
                             None if tile is None else tuple(tile))
        if not place.fits:
            raise ValueError("resident_chunk: cannot hold the fields in "
                             "shared memory: " + place.describe())
        (tx, ty, tz), cluster, threads = place.tile, place.cluster, \
            place.threads
        ctas, wide = place.tiles, False
        faces = torch.empty(
            1 if place.one_cluster
            else 2 * place.tiles * 6 * max(ty * tz, tx * tz, tx * ty),
            dtype=torch.float32, device=cur.device)
    else:
        if tile is not None:
            raise ValueError("resident_chunk: tile= is for resident=True")
        wide = _wide(cur.shape)
        ctas = streamed_ctas(cur.shape, _streamed_most(
            cur.device.index if cur.device.index is not None
            else torch.cuda.current_device(), wide))
        tx = ty = tz = cluster = 1
        threads = STREAM_THREADS
        faces = torch.empty(1, dtype=torch.float32, device=cur.device)
    out_a, out_b = torch.empty_like(cur), torch.empty_like(cur)
    lib = _kernel_lib()
    err = lib.wv_probe_resident_f32(
        cur.data_ptr(), prev.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        faces.data_ptr(), X, Y, Z, tx, ty, tz, cluster, ctas, threads, K,
        int(resident), int(wide),
        torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        raise RuntimeError("probe_resident launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    resident_chunk.launches += 1
    resident_chunk.last_grid = {"ctas": ctas, "threads": threads,
                                "cluster": cluster if resident else None}
    return (out_b, out_a) if K % 2 else (out_a, out_b)


resident_chunk.launches = 0
resident_chunk.last_grid = None


def make_run(X, Y, Z, K, device="cuda", resident=True):
    """``run(cur, prev, nchunks)``: ``nchunks`` calls of ``resident_chunk``
    of K sub-steps each, then the reference's scalar Σ cur[8, 8, :8], as a
    0-d tensor on the fields' device (X and Y must exceed 8)."""
    def run(cur, prev, nchunks):
        if tuple(cur.shape) != (X, Y, Z) \
                or cur.device.type != torch.device(device).type:
            raise ValueError(f"run: fields must be {(X, Y, Z)} on {device}, "
                             f"got {tuple(cur.shape)} on {cur.device}")
        for _ in range(nchunks):
            cur, prev = resident_chunk(cur, prev, K, resident=resident)
        return cur[8, 8, :8].sum()
    return run


# ---------------------------------------------------------------------------
# the sweep

def bound_us(dims, K: int, resident: bool):
    """(µs a sub-step, "bytes" or "operations"): the larger of bytes over
    the memory rate and float32 operations over the float32 rate.  Resident:
    both fields in and out once a launch, 16 B a node / K.  Device memory:
    12 B a node a sub-step (src read, dst read and written)."""
    n = math.prod(dims)
    moved = 2 * BYTES_PER_NODE * n / K if resident else 12 * n
    return roofline.bound_us(moved, OPS_PER_NODE * n)


def smem_floor_us(place: Placement, sm_clock_mhz: float) -> float:
    """A floor of a resident sub-step, not a bound: the busiest tile's
    shared-memory traffic over 128 B a clock of one SM at the given clock."""
    return SMEM_BYTES_PER_NODE * math.prod(place.tile) \
        / SMEM_BYTES_PER_CLOCK / sm_clock_mhz


@functools.cache
def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def impulse_fields(dims, device):
    """The reference's start: cur zero but 1 at the centre, prev zero."""
    cur = torch.zeros(dims, dtype=torch.float32, device=device)
    cur[tuple(d // 2 for d in dims)] = 1.0
    return cur, torch.zeros_like(cur)


def sweep_case(dims, resident: bool, K: int, device="cuda"):
    """One row of the sweep: ``nchunks = max(1, 512 // K)`` launches of K
    sub-steps through ``make_run``, timed with CUDA events after one warm-up
    launch (``build_s`` is that launch on the host, the first build
    included; ``tiles`` the CTAs it launched).  A launch of a small grid takes less time on the card than
    the wrapper takes on the host, so a spin kernel (``torch.cuda._sleep``)
    holds the stream for twice the host's time to enqueue the launches and
    the events time them back to back.  A resident shape that cannot be
    placed gives ``fits: False`` with the bytes needed and available, and
    launches nothing."""
    X, Y, Z = dims
    capacity = resident_capacity(device)
    row = {"shape": list(dims), "mode": "resident" if resident
           else "device_memory", "K": K,
           "buffers_mb": BYTES_PER_NODE * X * Y * Z / 1e6}
    if resident:
        place = _cached_plan(tuple(dims), capacity, None)
        if not place.fits:
            return {**row, "ok": False, "fits": False,
                    "bytes_needed": place.bytes_needed,
                    "bytes_available": place.bytes_available}
        row.update(tile=list(place.tile),
                   bytes_per_cta=place.bytes_per_cta, cluster=place.cluster,
                   threads=place.threads, cost=place.cost,
                   barrier="cluster" if place.one_cluster else "grid",
                   smem_floor_us=smem_floor_us(place, max_sm_clock_mhz()))
    else:
        row.update(tile=None, bytes_per_cta=0)
    run = make_run(X, Y, Z, K, device, resident)
    cur, prev = impulse_fields(dims, device)
    nchunks = max(1, 512 // K)
    t0 = time.perf_counter()
    run(cur, prev, 1)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    row["tiles"] = resident_chunk.last_grid["ctas"]   # the launch's CTAs
    t0 = time.perf_counter()
    run(cur, prev, 4)
    torch.cuda.synchronize(device)
    host_s = (time.perf_counter() - t0) / 4
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * nchunks * host_s * 2e9))  # cycles at <= 2 GHz
    start.record()
    value = run(cur, prev, nchunks)
    stop.record()
    torch.cuda.synchronize(device)
    dt = start.elapsed_time(stop) / 1e3
    steps = K * nchunks
    bound, by = bound_us(dims, K, resident)
    value = float(value)
    return {**row, "ok": math.isfinite(value), "nchunks": nchunks,
            "build_s": build_s, "us_per_step": 1e6 * dt / steps,
            "updates_per_s": X * Y * Z * steps / dt,
            "bound_us": bound, "bound_by": by, "value": value}


def sweep(device="cuda"):
    """Every (shape, mode, K) of the sweep, as ``sweep_case`` rows."""
    return [sweep_case(dims, resident, K, device)
            for dims in SWEEP_SHAPES for resident in (True, False)
            for K in SWEEP_KS]


def step0(device="cuda", n=2000):
    """What the runtime accepts and what a barrier costs, for the design:
    the clusters of 1..16 CTAs of 1,024 threads and the most shared memory
    a CTA may opt in to that can be resident at once (``Capacity.clusters``,
    by ``cudaOccupancyMaxActiveClusters``), and per barrier kind and
    launch, in CTAs of that size, the µs a barrier ((n barriers − none) /
    n, by CUDA events) or the launch's refusal.  Cooperative launches with
    clusters are only made where the clusters fit at once."""
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    capacity = resident_capacity(device)
    sms, smem = capacity.sms, capacity.smem_per_cta
    clusters = {c: capacity.clusters_at_once(c) for c in CLUSTER_SIZES}

    def time_us(kind, ctas, cluster, coop):
        def launch(count):
            return lib.wv_probe_barrier(count, kind, ctas, cluster, coop,
                                        smem, stream)
        err = launch(1)
        if err != 0:
            return lib.wv_cuda_error_string(err).decode()
        torch.cuda.synchronize(device)
        times = []
        for count in (0, n):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(count)
            stop.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(stop))
        return 1e3 * (times[1] - times[0]) / n

    rows = [("grid.sync", 0, sms, 1, 1), ("grid.sync", 0, 128, 1, 1)]
    for c in (2, 4, 8, 16):
        if clusters[c] > 0:
            ctas = c * min(clusters[c], 128 // c)
            rows += [("grid.sync", 0, ctas, c, 1),
                     ("cluster arrive + grid.sync + cluster wait", 2, ctas,
                      c, 1),
                     ("cluster.sync", 1, ctas, c, 0)]
        rows.append(("cluster.sync", 1, c, c, 0))
    barriers = [{"barrier": what, "ctas": ctas, "cluster": c,
                 "cooperative": bool(coop),
                 "us": time_us(kind, ctas, c, coop)}
                for what, kind, ctas, c, coop in rows]
    return {"clusters_resident": clusters, "smem_per_cta": smem,
            "threads": 1024, "max_sm_clock_mhz": max_sm_clock_mhz(),
            "barriers": barriers}


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_resident: needs a CUDA device")
    print(card_name_and_power_limit(), flush=True)
    if "--step0" in sys.argv[1:]:
        print(json.dumps(step0()), flush=True)
        return
    for row in sweep():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
