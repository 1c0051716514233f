"""Time the shoebox kernels at the hall: the chunk kernel B2 (and B6, its
grad mode), with ``--kernel b7`` the chunk's adjoint B7, with ``--kernel
b1`` the fused step B1, with ``--kernel b5`` the fused step's adjoint B5.

    python -m wayverb_tpu_torch.tools.mega_timing [--kernel b1|b5|b7]

On the card, at the concert-hall shoebox of ``bench.py`` (224, 224, 256)
meshed at the engine's rate, with the hall run's hard source at the centre
and its receiver's taps, the default mode:

* builds ``csrc/box_mega_chunk.cu`` and prints ptxas's registers, stack and
  spills for each kernel in it, and what the card makes of the chunk kernel
  (``box_mega.chunk_occupancy``: registers, local bytes, CTAs an SM, the
  cooperative grid);
* holds one K = 128 chunk of B2 and of B6 against the plain version
  (``_mega_chunk_plain``) on the same random state, to the bit, and B6's
  outputs against B2's;
* times B2 and B6 (µs a sub-step: CUDA events over a few chunks);
* profiles one B2 chunk with ``torch.profiler``: the kernels it launched
  (the chunk kernel's own, ``mega_*``, and the wrapper's allocations),
  their count and device time by name, the chunk's span on the device (CUDA
  events) and the gaps (the span less the kernels' time).

``--kernel b7`` does the same for ``csrc/box_mega_chunk_bwd.cu``: ptxas's
report and ``box_mega.chunk_bwd_occupancy``; one K = 128 chunk of B7 on
random cotangents against ``_mega_chunk_bwd_plain``, each of its six
outputs within 1e-5 of its largest value (the largest error of each
printed); B7's µs a sub-step, chained chunk to chunk as the backward runs
them; and one profiled chunk (its kernels, ``*bwd_*``, by name).

``--kernel b1`` builds ``csrc/box_fused_step.cu`` (ptxas's report) and reads
``box_fused.step_occupancy`` at each shape; holds B1 to the bit against
``_fused_step_plain`` (``next`` and the six inner planes) at the hall, with
a hard source at the centre, and at the sharded hall's shard shape (56,
224, 256), the second of four shards with random halo rows and a source in
the shard; and times B1 at both shapes with the stream held
(``device_time_us``: a step takes less time on the card than its wrapper
takes on the host), beside the wrapper's host µs a call, the plain
version's µs at the hall and each shape's bound (``tools/roofline.py``).

``--kernel b5`` builds ``csrc/box_fused_step_bwd.cu`` (ptxas's report),
reads ``box_fused.step_bwd_occupancy`` at each shape (null on a tree
without it), gives the shares of the (warp, row) pairs on each of B5's
three paths (``b5_warp_shares``), holds B5 to the bit (``bits_equal``: −0
apart from +0, NaN for NaN) against ``_fused_step_bwd_plain`` in gcur,
gprev, the six plane cotangents and both halo cotangents, on random,
1e38 / ±inf / NaN and all −0 cotangents with a hard source in the block, at
the hall and at the sharded hall's shard shape (56, 224, 256), the second
of four shards; and times B5 at both shapes with the stream held, beside
the wrapper's host µs a call, the plain version's µs at the hall and each
shape's bound (``b5_bound``).

One JSON line, after the card's name and power limit.  Without a card it
fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wayverb_tpu_torch.tools.probe_resident import card_name_and_power_limit

FS = 500.0 / (0.25 * 0.6)   # the engine's mesh rate at a 500 Hz cutoff
SIDE = (224, 224, 256)      # bench.py's production-scale shoebox
ABSORPTION = 0.1
CHUNK = 128
SEED = 20261111
BWD_REL = 1e-5              # B7 against its plain version, of the largest


def hall_case(device="cuda"):
    """(spec, face_b, face_a, src (x, y, z, mode), tap indices) of the hall
    run: source at the centre, receiver 4 nodes off it in z."""
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import face_coefficients
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    box = Box((0, 0, 0), tuple(dx * (s - 4) for s in SIDE))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), ABSORPTION), dx, FS,
                              device=device)
    centre = np.asarray(box.centre())
    source, receiver, _, _ = wgrun.canonical_problem(
        mesh, tuple(centre), tuple(centre + np.asarray([0.0, 0.0, 4 * dx])),
        CHUNK / FS)
    spec = mesh.box_spec
    fb, fa = face_coefficients(mesh.structure, spec)
    src = tuple(int(v) for v in source.kernel_injection(spec.dims, 0)[0])
    taps = receiver.tap_nodes().reshape(-1).to(torch.int64).contiguous()
    return spec, fb, fa, src, taps


def random_state(spec, order, gen, device="cuda"):
    """Random (cur, prev, st, pln), zero in the planes' padding."""
    from wayverb_tpu_torch.waveguide.box_fused import stacked_plane_shape
    Umax, Vmax = stacked_plane_shape(spec)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    mask = torch.zeros((6, Umax, Vmax), device=device)
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    st = (rnd(order, 6, Umax, Vmax) * mask).contiguous()
    pln = (rnd(3, 6, Umax, Vmax) * mask).contiguous()
    return rnd(*spec.dims), rnd(*spec.dims), st, pln


def ptxas_lines(source="box_mega_chunk") -> list[str]:
    """ptxas's report of each kernel of ``csrc/<source>.cu``, from a fresh
    build."""
    from wayverb_tpu_torch import _build
    log = _build.build(source, force=True)[1]
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def compare(case, gen, grad=False):
    """One chunk of the kernel and of the plain version on the same random
    state: (all outputs equal, max |Δ|, kernel outputs)."""
    from wayverb_tpu_torch.waveguide.box_mega import (_mega_chunk_plain,
                                                      mega_chunk)
    spec, fb, fa, src, taps = case
    state = random_state(spec, fb.shape[1] - 1, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda")
    want = _mega_chunk_plain(spec, sig, fb, fa, *state, src, taps, grad=grad)
    got = mega_chunk(spec, sig, fb, fa, *(t.clone() for t in state), src,
                     taps, grad=grad)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return equal, err, got


def events_us(fn, reps: int) -> float:
    """µs of one ``fn()`` by CUDA events over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / reps


def chunk_us(case, gen, grad=False, reps=5) -> float:
    """µs of one K = CHUNK chunk at the case's shape."""
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    spec, fb, fa, src, taps = case
    state = random_state(spec, fb.shape[1] - 1, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda") * 1e-3
    return events_us(lambda: mega_chunk(spec, sig, fb, fa, *state, src, taps,
                                        grad=grad), reps)


def device_time_us(fn, reps: int):
    """(device µs of one ``fn()``, host µs of one call).  A kernel that
    takes less time on the card than its wrapper takes on the host would,
    timed by events around a plain loop, give the host's launch rate: a
    spin kernel (``torch.cuda._sleep``) holds the stream for twice the time
    the host needs to enqueue ``reps`` calls, and the events then time the
    kernels back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        fn()
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / 8
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * host_us * 2000))  # cycles at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / reps, host_us


def b1_bound(dims, halos: bool):
    """(µs, "bytes" or "operations") of one B1 step on a field of ``dims``:
    cur, prev and the six planes in, next and the six inner planes out, and
    with halos the two halo rows in; 8 operations a node."""
    from wayverb_tpu_torch.tools import roofline
    X, Y, Z = dims
    n = X * Y * Z
    natural = 2 * (Y * Z + X * Z + X * Y)
    return roofline.bound_us(4 * (3 * n + 2 * natural + 2 * Y * Z * halos),
                             8 * n)


def b1_step_case(spec, x_offset: int, rows: int, gen, halos: bool):
    """Random inputs of one B1 step on ``rows`` x rows of ``spec`` from
    local row 0 = global row ``x_offset``, with a hard source at the
    centre of that block: (geom, cur, prev, planes, inj_idx, inj_val,
    halos)."""
    from wayverb_tpu_torch.waveguide.box_fused import _plane_shapes
    _, Y, Z = spec.dims
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    cur, prev = rnd(rows, Y, Z), rnd(rows, Y, Z)
    planes = tuple(rnd(*s) for s in _plane_shapes(rows, Y, Z))
    hal = (rnd(1, Y, Z), rnd(1, Y, Z)) if halos else None
    src = (x_offset + rows // 2, Y // 2, Z // 2, 1)
    return (spec.geom_array(x_offset=x_offset), cur, prev, planes, src,
            rnd(2), hal)


def b1_shape(spec, x_offset, rows, gen, halos, plain_reps=0) -> dict:
    """B1 on one shape: to the bit against the plain version, its device
    and host µs a step, the plain version's µs (when ``plain_reps``), its
    bound and what the card makes of the kernel there."""
    from wayverb_tpu_torch.waveguide.box_fused import (_fused_step_plain,
                                                       fused_step,
                                                       step_occupancy)
    args = b1_step_case(spec, x_offset, rows, gen, halos)
    geom, cur, prev, planes, src, inj_val, hal = args
    got = fused_step(*args)
    want = _fused_step_plain(*args)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(g, w))
                for g, w in zip((got[0], *got[1]), (want[0], *want[1])))
    err = max(float((g - w).abs().max())
              for g, w in zip((got[0], *got[1]), (want[0], *want[1])))
    del got, want
    out = torch.empty_like(cur)
    us, host_us = device_time_us(lambda: fused_step(
        geom, cur, prev, planes, src, inj_val, hal, out=out), 200)
    dims = tuple(cur.shape)
    bound = b1_bound(dims, halos)
    row = {"shape": list(dims), "x_offset": x_offset, "halos": halos,
           "equal_plain": equal, "max_abs_err": err, "us_per_step": us,
           "host_us_per_call": host_us, "bound_us": bound[0],
           "bound_by": bound[1], "time_over_bound": us / bound[0],
           "occupancy": step_occupancy(dims=dims)}
    if plain_reps:
        row["plain_us_per_step"] = events_us(lambda: _fused_step_plain(
            geom, cur, prev, planes, src, inj_val, hal), plain_reps)
    return row


def main_b1():
    """The ``--kernel b1`` mode: one JSON line."""
    t0 = time.perf_counter()
    ptxas = ptxas_lines("box_fused_step")
    spec = hall_case()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    X = spec.dims[0]
    hall = b1_shape(spec, 0, X, gen, False, plain_reps=10)
    shard = b1_shape(spec, X // 4, X // 4, gen, True)
    print(json.dumps({"ptxas": ptxas, "hall": hall, "shard": shard,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    if not (hall["equal_plain"] and shard["equal_plain"]):
        raise SystemExit("mega_timing: B1 differs from its plain version")


def b5_bound(dims):
    """(µs, "bytes" or "operations") of one B5 launch on a field (or shard)
    of ``dims``: g and the six inner cotangents in; gcur, gprev, the six
    plane cotangents and the two halo rows out; 8 operations a node."""
    from wayverb_tpu_torch.tools import roofline
    X, Y, Z = dims
    n = X * Y * Z
    natural = 2 * (Y * Z + X * Z + X * Y)
    return roofline.bound_us(4 * (3 * n + 2 * natural + 2 * Y * Z), 8 * n)


B5_PATHS = ("bare", "z_only", "x_only", "general")


def b5_warp_paths(geom, dims, inj_idx=(0, 0, 0, 0)):
    """The path B5 takes in each warp and row (``csrc/box_fused_step_bwd.cu``):
    an (X, ⌈Y·Z/32⌉) int64 tensor indexing ``B5_PATHS``, warp s holding the
    nodes p = 32·s … 32·s + 31 of the flattened (y, z) plane.  A warp whose
    32 nodes all exist with y two or more inside the y walls is bare if
    their z are two inside the z walls too, else z only, in a row two or
    more inside in x that is not row 0 or X − 1; in the other rows a bare
    warp is x only.  Every other pair is general, and so is the pair that
    holds a hard source."""
    X, Y, Z = dims
    x_off, (ilo0, ihi0, ilo1, ihi1, ilo2, ihi2) = geom[0], geom[3:9]
    warps = -(-Y * Z // 32)
    p = torch.arange(32 * warps)
    y, z = p // Z, p % Z
    y_in = (p < Y * Z) & (y >= ilo1 + 2) & (y <= ihi1 - 2)
    z_in = (z >= ilo2 + 2) & (z <= ihi2 - 2)
    bare = (y_in & z_in).view(warps, 32).all(1)
    z_only = y_in.view(warps, 32).all(1)
    in_yz = torch.where(bare, 0, torch.where(z_only, 1, 3))
    x = torch.arange(X)
    row_in = ((x_off + x >= ilo0 + 2) & (x_off + x <= ihi0 - 2) & (x > 0)
              & (x < X - 1))
    paths = torch.where(row_in[:, None], in_yz[None, :],
                        torch.where(in_yz == 0, 2, 3)[None, :])
    sx, sy, sz, mode = inj_idx
    if mode == 1 and 0 <= sx - x_off < X and 0 <= sy < Y and 0 <= sz < Z:
        paths[sx - x_off, (sy * Z + sz) // 32] = 3
    return paths


def b5_node_paths(geom, dims, inj_idx=(0, 0, 0, 0)):
    """The path of each node of an (X, Y, Z) field in B5: its warp's in its
    row (``b5_warp_paths``)."""
    X, Y, Z = dims
    paths = b5_warp_paths(geom, dims, inj_idx)
    return paths.repeat_interleave(32, 1)[:, :Y * Z].reshape(X, Y, Z)


def b5_warp_shares(geom, dims, inj_idx=(0, 0, 0, 0)) -> dict:
    """The share of B5's (warp, row) pairs on each path
    (``b5_warp_paths``)."""
    paths = b5_warp_paths(geom, dims, inj_idx)
    return {name: float((paths == k).float().mean())
            for k, name in enumerate(B5_PATHS)}


def b5_case(spec, x_offset: int, rows: int, gen, kind="random"):
    """Inputs of one B5 launch on ``rows`` x rows of ``spec`` from local
    row 0 = global row ``x_offset``: g and the six inner cotangents of
    ``kind`` (``mesh_timing.case_g``) on ``gen``'s device and a hard source
    at the centre of the block: (geom, g, ginner, inj_idx)."""
    from wayverb_tpu_torch.tools.mesh_timing import case_g
    from wayverb_tpu_torch.waveguide.box_fused import _plane_shapes
    _, Y, Z = spec.dims
    shape = (rows, Y, Z)
    g = case_g(kind, shape, gen)
    ginner = tuple(case_g(kind, s, gen) for s in _plane_shapes(*shape))
    return (spec.geom_array(x_offset=x_offset), g, ginner,
            (x_offset + rows // 2, Y // 2, Z // 2, 1))


def b5_equal(args) -> dict:
    """B5 (``fused_step_bwd``) and its plain version on ``args``: whether
    gcur, gprev, the six plane cotangents and both halo cotangents agree to
    the bit, the names of those that do not, and the largest finite
    |kernel − plain|."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    from wayverb_tpu_torch.waveguide.box_fused import (_fused_step_bwd_plain,
                                                       fused_step_bwd)
    flat = lambda r: (r[0], r[1], *r[2], *r[3])  # noqa: E731
    got = flat(fused_step_bwd(*args))
    want = flat(_fused_step_bwd_plain(*args))
    if got[0].is_cuda:
        torch.cuda.synchronize()
    names = ("gcur", "gprev", *(f"gplane{q}" for q in range(6)), "ghlo",
             "ghhi")
    differ = [n for n, a, b in zip(names, got, want) if not bits_equal(a, b)]
    err = max(float((a - b).abs().nan_to_num(0.0, 0.0, 0.0).max())
              for a, b in zip(got, want))
    return {"equal": not differ, "differ": differ, "max_abs_err": err}


def b5_shape(spec, x_offset, rows, gen, plain_reps=0) -> dict:
    """B5 on one shape: to the bit against the plain version on each kind
    of cotangent, its device and host µs a launch, the plain version's µs
    (when ``plain_reps``), its bound, its warp paths and what the card
    makes of the kernel there (None on a tree without the query)."""
    from wayverb_tpu_torch.waveguide import box_fused as bf
    checks = {kind: b5_equal(b5_case(spec, x_offset, rows, gen, kind))
              for kind in ("random", "1e38 inf nan", "all -0")}
    args = b5_case(spec, x_offset, rows, gen)
    us, host_us = device_time_us(lambda: bf.fused_step_bwd(*args), 200)
    dims = (rows,) + tuple(spec.dims[1:])
    bound = b5_bound(dims)
    row = {"shape": list(dims), "x_offset": x_offset,
           "equal_plain": all(c["equal"] for c in checks.values()),
           "checks": checks, "us_per_launch": us,
           "host_us_per_call": host_us, "bound_us": bound[0],
           "bound_by": bound[1], "time_over_bound": us / bound[0],
           "warp_shares": b5_warp_shares(args[0], dims, args[3]),
           "occupancy": (bf.step_bwd_occupancy(dims=dims)
                         if hasattr(bf, "step_bwd_occupancy") else None)}
    if plain_reps:
        row["plain_us"] = events_us(
            lambda: bf._fused_step_bwd_plain(*args), plain_reps)
    return row


def main_b5():
    """The ``--kernel b5`` mode: one JSON line."""
    t0 = time.perf_counter()
    ptxas = ptxas_lines("box_fused_step_bwd")
    spec = hall_case()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    X = spec.dims[0]
    hall = b5_shape(spec, 0, X, gen, plain_reps=10)
    shard = b5_shape(spec, X // 4, X // 4, gen)
    print(json.dumps({"kernel": "b5", "ptxas": ptxas, "hall": hall,
                      "shard": shard, "wall_s": time.perf_counter() - t0}),
          flush=True)
    if not (hall["equal_plain"] and shard["equal_plain"]):
        raise SystemExit("mega_timing: B5 differs from its plain version")


def profile(run, marker) -> dict:
    """``run()`` once more after a warm-up, under torch.profiler: {kernel
    name: [launches, device µs]}, the launches of kernels whose name holds
    ``marker``, the kernels' total, the span by CUDA events, and the gaps
    (span - total; None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
    span_us = 1e3 * start.elapsed_time(stop)
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0:
                kernels[e.key[:80]] = [e.count, t]
    busy = sum(t for _, t in kernels.values())
    chunk = sum(n for name, (n, _) in kernels.items() if marker in name)
    return {"kernels": kernels, "chunk_launches": chunk, "device_us": busy,
            "span_us": span_us,
            "gaps_us": span_us - busy if busy > 0 else None}


def profile_chunk(case, gen) -> dict:
    """One B2 chunk under torch.profiler (``profile``; the chunk kernel's
    name holds ``mega_``)."""
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    spec, fb, fa, src, taps = case
    state = random_state(spec, fb.shape[1] - 1, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda") * 1e-3
    return profile(lambda: mega_chunk(spec, sig, fb, fa, *state, src, taps),
                   "mega_")


def random_cotangents(spec, order, k, gen, device="cuda"):
    """Random (gtaps (K, k), gnext, gcur, gst), zero in the planes'
    padding."""
    gst = random_state(spec, order, gen, device)[2]
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    return rnd(CHUNK, k), rnd(*spec.dims), rnd(*spec.dims), gst


def compare_bwd(case, gen) -> dict:
    """One chunk of B7 and of ``_mega_chunk_bwd_plain`` on the same random
    cotangents: per output, the largest |kernel - plain| and that over the
    output's largest value."""
    from wayverb_tpu_torch.waveguide.box_mega import (_mega_chunk_bwd_plain,
                                                      mega_chunk_bwd)
    spec, fb, fa, src, taps = case
    cot = random_cotangents(spec, fb.shape[1] - 1, taps.numel(), gen)
    want = _mega_chunk_bwd_plain(spec, fb, fa, *cot, src, taps)
    got = mega_chunk_bwd(spec, fb, fa, *(t.clone() for t in cot), src, taps)
    torch.cuda.synchronize()
    out = {}
    for name, g, w in zip(("gnext", "gcur", "gst", "gsig", "gp_stream",
                           "gstin_stream"), got, want):
        err = float((g - w).abs().max())
        out[name] = {"max_abs_err": err,
                     "rel": err / max(float(w.abs().max()), 1e-30)}
    return out


def bwd_run(case, gen):
    """A callable that runs one B7 chunk on carried cotangents: the kernel
    consumes its field and state cotangents, so each call chains on the
    previous one's, as the backward's chunks do."""
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk_bwd
    spec, fb, fa, src, taps = case
    gtaps, gnext, gcur, gst = random_cotangents(spec, fb.shape[1] - 1,
                                                taps.numel(), gen)
    carry = [gnext * 1e-3, gcur * 1e-3, gst * 0.0]

    def run():
        carry[:] = mega_chunk_bwd(spec, fb, fa, gtaps, *carry, src, taps)[:3]
    return run


def main_b7():
    """The ``--kernel b7`` mode: one JSON line."""
    from wayverb_tpu_torch.waveguide.box_mega import chunk_bwd_occupancy
    t0 = time.perf_counter()
    ptxas = ptxas_lines("box_mega_chunk_bwd")
    occupancy = chunk_bwd_occupancy()
    case = hall_case()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = compare_bwd(case, gen)
    torch.cuda.empty_cache()
    b7 = events_us(bwd_run(case, gen), 5)
    prof = profile(bwd_run(case, gen), "bwd_")
    ok = all(e["rel"] <= BWD_REL for e in errs.values())
    print(json.dumps({
        "shape": list(case[0].dims), "K": CHUNK, "ptxas": ptxas,
        "occupancy": occupancy, "b7_us_per_substep": b7 / CHUNK,
        "b7_vs_plain": errs, "b7_within_bound": ok, "bound_rel": BWD_REL,
        "profile": prof, "wall_s": time.perf_counter() - t0}), flush=True)
    if not ok:
        raise SystemExit("mega_timing: B7 differs from its plain version")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wayverb_tpu_torch.tools.mega_timing",
        description="Time the chunk kernels B2/B6 (default), B7, the fused "
                    "step B1 or its adjoint B5 at the hall.")
    p.add_argument("--kernel", choices=("b1", "b2", "b5", "b7"),
                   default="b2")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mega_timing: needs a CUDA device")
    print(card_name_and_power_limit(), flush=True)
    modes = {"b1": main_b1, "b5": main_b5, "b7": main_b7}
    if args.kernel in modes:
        return modes[args.kernel]()
    from wayverb_tpu_torch.waveguide.box_mega import chunk_occupancy
    t0 = time.perf_counter()
    ptxas = ptxas_lines()
    occupancy = chunk_occupancy()
    case = hall_case()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b2_equal, b2_err, b2_out = compare(case, gen)
    gen_b6 = torch.Generator(device="cuda").manual_seed(SEED)
    b6_equal, b6_err, b6_out = compare(case, gen_b6, grad=True)
    b6_same = all(bool(torch.equal(a, b)) for a, b in zip(b6_out[:6],
                                                          b2_out))
    del b2_out, b6_out
    torch.cuda.empty_cache()
    b2 = chunk_us(case, gen)
    b6 = chunk_us(case, gen, grad=True)
    prof = profile_chunk(case, gen)
    print(json.dumps({
        "shape": list(case[0].dims), "K": CHUNK, "ptxas": ptxas,
        "occupancy": occupancy,
        "b2_us_per_substep": b2 / CHUNK, "b6_us_per_substep": b6 / CHUNK,
        "b2_equal_plain": b2_equal, "b2_max_abs_err": b2_err,
        "b6_equal_plain": b6_equal, "b6_max_abs_err": b6_err,
        "b6_forward_equal_b2": b6_same, "profile": prof,
        "wall_s": time.perf_counter() - t0}), flush=True)
    if not (b2_equal and b6_equal and b6_same):
        raise SystemExit("mega_timing: the kernel differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
