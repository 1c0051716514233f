"""Probe: K bare leapfrog sub-steps with both fields held on chip.

Port of ``tools/bench/probe_vmem_resident.py`` (the TPU probe that became the
mega chunk kernel): per node and sub-step

    dst = C2 · (((((x− + x+) + y−) + y+) + z−) + z+) − dst,    C2 = 1/3,

the sum over ``src``, zero beyond the grid, ``src`` and ``dst`` swapping
roles every sub-step.  No boundary filters, no source, no taps.

On the TPU one core holds both fields of a (224, 224, 256) grid in VMEM.  On
the H100 the on-chip store is shared memory, at most 232,448 B a CTA, so
``resident_chunk`` launches the hand-written kernel ``csrc/probe_resident.cu``
once per call as a cooperative grid of one CTA per SM with a grid barrier
between sub-steps, in one of two modes:

* ``resident=True``: each CTA holds one tile of both fields in shared memory
  for all K sub-steps and exchanges the tile's faces through device memory
  (``plan_tiles`` places the tiles; a grid it cannot place raises
  ``ValueError`` before any launch);
* ``resident=False``: the same grid and barrier, the fields in device memory
  (and L2 while they fit it).

CPU tensors run the plain version ``chunk_plain``; CUDA tensors launch the
kernel or raise.  Launches are counted in ``resident_chunk.launches``.

The reference updates only the first ``X − X % 8`` planes (its slab loop runs
``X // 8`` times) and runs ``K − 1`` sub-steps for odd K; the port updates
every plane and runs exactly K sub-steps (ROADMAP §C).

    python -m wayverb_tpu_torch.tools.probe_resident

runs the sweep on the card (``main``): one JSON line per (shape, mode, K).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import subprocess
import time

import torch

from wayverb_tpu_torch.tools import roofline

C2 = 1.0 / 3.0
BYTES_PER_NODE = 8             # both float32 fields
OPS_PER_NODE = 7               # 5 adds, a multiply, a subtract a sub-step

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
    CTA may opt in to, and the L2 size, in bytes."""
    sms: int
    smem_per_cta: int
    l2_bytes: int


@dataclasses.dataclass(frozen=True)
class Placement:
    """A resident run's tiling: ``tile`` (tx, ty, tz) and ``tiles`` CTAs of
    ``bytes_per_cta`` shared memory, or ``tile`` None when the grid cannot
    be placed.  ``bytes_needed`` is both fields, ``bytes_available`` the
    shared memory of all SMs."""
    dims: tuple
    tile: tuple | None
    tiles: int
    bytes_per_cta: int
    bytes_needed: int
    bytes_available: int

    @property
    def fits(self) -> bool:
        return self.tile is not None

    def describe(self) -> str:
        if self.fits:
            return (f"{self.tiles} tiles of {self.tile}, "
                    f"{self.bytes_per_cta} B each")
        return (f"grid {self.dims} needs {self.bytes_needed} B of shared "
                f"memory for both fields; the card holds "
                f"{self.bytes_available} B")


@functools.cache
def _device_capacity(index: int) -> Capacity:
    lib = _kernel_lib()
    out = (ctypes.c_int * 3)()
    err = lib.wv_probe_device_attrs(index, out)
    if err != 0:
        raise RuntimeError("probe_resident: reading the device's "
                           "attributes failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return Capacity(*out)


def resident_capacity(device="cuda", *, sms=None, smem_per_cta=None,
                      l2_bytes=None) -> Capacity:
    """The card's SM count, ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` and
    L2 size, read from the CUDA device.  For any other device (the CPU) the
    three numbers are given: ``resident_capacity("cpu", sms=132,
    smem_per_cta=232448, l2_bytes=50 * 2**20)`` is the H100 SXM."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return _device_capacity(index)
    if None in (sms, smem_per_cta, l2_bytes):
        raise ValueError("resident_capacity: give sms, smem_per_cta and "
                         f"l2_bytes for a {device.type} device")
    return Capacity(sms, smem_per_cta, l2_bytes)


def _lengths(n: int):
    """The distinct tile lengths ceil(n / k) for k = 1..n."""
    return sorted({-(-n // k) for k in range(1, n + 1)}, reverse=True)


def _placement(dims, tile, capacity: Capacity) -> Placement:
    X, Y, Z = dims
    tx, ty, tz = tile
    tiles = -(-X // tx) * -(-Y // ty) * -(-Z // tz)
    per = BYTES_PER_NODE * tx * ty * tz
    ok = per <= capacity.smem_per_cta and tiles <= capacity.sms
    return Placement(tuple(dims), tuple(tile) if ok else None, tiles, per,
                     BYTES_PER_NODE * X * Y * Z,
                     capacity.sms * capacity.smem_per_cta)


def plan_tiles(dims, capacity: Capacity, tile=None) -> Placement:
    """Where a resident run of ``dims`` goes: the fewest tiles, one CTA
    each, whose two fields fit a CTA's shared memory, at most one per SM;
    among those, tiles that span z (whole rows), then the least face area
    exchanged a sub-step.  ``tile`` checks a given (tx, ty, tz) instead.
    The result's ``fits`` is False when nothing fits."""
    X, Y, Z = (int(d) for d in dims)
    if min(X, Y, Z) < 1:
        raise ValueError(f"plan_tiles: empty grid {dims}")
    if tile is not None:
        if len(tile) != 3 or not all(1 <= t <= d for t, d in
                                     zip(tile, (X, Y, Z))):
            raise ValueError(f"plan_tiles: tile {tile} does not fit in "
                             f"grid {dims}")
        return _placement((X, Y, Z), tile, capacity)
    best = None
    for tz in _lengths(Z):
        for ty in _lengths(Y):
            if BYTES_PER_NODE * ty * tz > capacity.smem_per_cta:
                continue
            for tx in _lengths(X):
                p = _placement((X, Y, Z), (tx, ty, tz), capacity)
                if not p.fits:
                    continue
                split = (-(-X // tx) > 1, -(-Y // ty) > 1, -(-Z // tz) > 1)
                face = 2 * (split[0] * ty * tz + split[1] * tx * tz
                            + split[2] * tx * ty)
                key = (p.tiles, tz != Z, face, -tx)
                if best is None or key < best[0]:
                    best = (key, p)
    if best is not None:
        return best[1]
    return Placement((X, Y, Z), None, 0, 0, BYTES_PER_NODE * X * Y * Z,
                     capacity.sms * capacity.smem_per_cta)


# the search takes milliseconds (50 ms at (64, 224, 256)), far longer than a
# launch, so the wrapper asks it once per (dims, capacity, tile)
_cached_plan = functools.lru_cache(maxsize=256)(plan_tiles)


# ---------------------------------------------------------------------------
# launching

@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("probe_resident")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wv_probe_resident_f32.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.wv_probe_resident_f32.restype = ctypes.c_int
    lib.wv_probe_device_attrs.argtypes = [i, ctypes.POINTER(i)]
    lib.wv_probe_device_attrs.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    (counted in ``resident_chunk.launches``) or raise: ``resident=True``
    holds the fields in shared memory, in the tiling ``plan_tiles`` gives
    (or the given ``tile``), and raises ``ValueError`` before any launch
    when the grid cannot be placed; ``resident=False`` keeps them in device
    memory.
    """
    _check_fields(cur, prev, K)
    if cur.device.type == "cpu":
        return chunk_plain(cur, prev, K)
    if not cur.is_cuda:
        raise ValueError(f"resident_chunk: no kernel for device {cur.device}")
    X, Y, Z = cur.shape
    capacity = resident_capacity(cur.device)
    if resident:
        place = _cached_plan(tuple(cur.shape), capacity,
                             None if tile is None else tuple(tile))
        if not place.fits:
            raise ValueError("resident_chunk: cannot hold the fields in "
                             "shared memory: " + place.describe())
        tx, ty, tz = place.tile
        ctas = place.tiles
        faces = torch.empty(
            2 * ctas * 6 * max(ty * tz, tx * tz, tx * ty) if ctas > 1 else 1,
            dtype=torch.float32, device=cur.device)
    else:
        if tile is not None:
            raise ValueError("resident_chunk: tile= is for resident=True")
        tx, ty, tz, ctas = 1, 1, 1, capacity.sms
        faces = torch.empty(1, dtype=torch.float32, device=cur.device)
    out_a, out_b = torch.empty_like(cur), torch.empty_like(cur)
    lib = _kernel_lib()
    err = lib.wv_probe_resident_f32(
        cur.data_ptr(), prev.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        faces.data_ptr(), X, Y, Z, tx, ty, tz, K, int(resident), ctas,
        torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        raise RuntimeError("probe_resident launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    resident_chunk.launches += 1
    return (out_b, out_a) if K % 2 else (out_a, out_b)


resident_chunk.launches = 0


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


def impulse_fields(dims, device):
    """The reference's start: cur zero but 1 at the centre, prev zero."""
    cur = torch.zeros(dims, dtype=torch.float32, device=device)
    cur[tuple(d // 2 for d in dims)] = 1.0
    return cur, torch.zeros_like(cur)


def sweep_case(dims, resident: bool, K: int, device="cuda"):
    """One row of the sweep: ``nchunks = max(1, 512 // K)`` launches of K
    sub-steps through ``make_run``, timed with CUDA events after one warm-up
    launch (``build_s`` is that launch on the host, the first build
    included).  A launch of a small grid takes less time on the card than
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
        row.update(tiles=place.tiles, tile=list(place.tile),
                   bytes_per_cta=place.bytes_per_cta)
    else:
        row.update(tiles=capacity.sms, tile=None, bytes_per_cta=0)
    run = make_run(X, Y, Z, K, device, resident)
    cur, prev = impulse_fields(dims, device)
    nchunks = max(1, 512 // K)
    t0 = time.perf_counter()
    run(cur, prev, 1)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
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


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_resident: needs a CUDA device")
    print(card_name_and_power_limit(), flush=True)
    for row in sweep():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
