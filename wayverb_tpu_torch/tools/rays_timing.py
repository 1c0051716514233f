"""Time the ray–triangle paths of ``trace``, and the closest-hit kernels alone.

Port of ``tools/bench/rays_timing.py``, with the large hall of
``bench.py``'s ``bench_rays_large``.  Two modes:

* trace (the default): ``trace`` on ``procedural_hall()`` (5,448 triangles)
  with each backend, ``mt`` (kernel B3), ``dense`` (the (R, T) broadcast)
  and ``grid`` (the voxel DDA), and on ``procedural_hall_large()`` (97,068
  triangles) with ``large_b4`` (the culled kernel B4) and
  ``large_all_pairs`` (B3, ``cull=False``): 65,536 rays, 40 bounces, the
  reference's source and receiver.  One JSON line a backend: seconds (the
  least of ``--reps`` runs after a one-bounce warm-up), ray-bounces/s, the
  deposited energy and the kernels' launches.
* ``--kernel b3`` or ``--kernel b4``: the kernel alone on the rays a trace
  gives it, recorded where ``mt_closest`` takes them: the closest-hit query
  of bounce 2 and the visibility query of bounce 20, where some rays have
  left the scene.  B3 runs on the model hall and on the large hall with
  ``cull=False``, B4 on the large hall.  The kernel is timed by CUDA events
  with the stream held while the host enqueues, and held against its plain
  version to the bit on both queries.  For B4 the plain version's gate is
  read per 512-ray tile: how many triangle tiles each ray tile let through
  (max, mean, percentiles, a histogram by tenths of the tile count), and the
  kernel's time over the most any ray tile scanned.  For B3, on both
  queries: the share of (warp, triangle) pairs that the scan's skip tests
  drop, with the rays in the tracer's order, the order the kernel takes
  them in.  The card's residency of either kernel.

    python -m wayverb_tpu_torch.tools.rays_timing [mt dense grid large_b4 large_all_pairs]
    python -m wayverb_tpu_torch.tools.rays_timing --kernel b3

It runs on the card unless given ``--device cpu``; there every ray query runs
the plain versions, the large hall is cut as ``bench.py`` cuts it for the
CPU, and every time is the host's.  Without a card and without
``--device cpu`` it fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.raytracer import accel as ray_accel
from wayverb_tpu_torch.raytracer import mt_kernels as mk
from wayverb_tpu_torch.raytracer import tracer
from wayverb_tpu_torch.raytracer.scenes import (procedural_hall,
                                                procedural_hall_large)
from wayverb_tpu_torch.tools import roofline
from wayverb_tpu_torch.tools.probe_resident import card_name_and_power_limit

RAYS = 1 << 16
DEPTH = 40
SRC, RCV = (2.0, 1.7, 3.0), (6.0, 1.9, 9.0)   # tools/bench/rays_timing.py
SEED = 7
ABSORPTION, SCATTERING = 0.1, 0.1
# the kernel cases: the rays of the model hall's engine run (its source and
# receiver) and of the large hall's trace, drawn from one seed
MODEL_SRC, MODEL_RCV = (6.0, 4.0, 5.0), (7.5, 3.0, 6.5)
KERNEL_SEED = 20261037
TIMED_BOUNCE = 2
LATE_BOUNCE = 20
# float32 arithmetic of the Möller–Trumbore test on one (ray, triangle) pair:
# the two cross products 9 each, the determinant 5, the reciprocal 1, o - v0
# 3, u, v and t 6 each, u + v 1.  One slab test: per axis two subtracts, two
# multiplies, two minima, two maxima.  A pair takes about 70 instructions
# with --fmad=false: the 46, about 14 compares and selects, the IEEE
# reciprocal's sequence and three shared-memory loads.
MT_OPS_PER_PAIR = 46
SLAB_OPS_PER_TILE = 24
INSTRUCTIONS_PER_PAIR = 70
# H100 SXM: 132 SMs of 128 float32 lanes at ~1.755 GHz
INSTRUCTIONS_PER_S = 132 * 128 * 1.755e9


class Mismatch(RuntimeError):
    """A kernel's result differs from its plain version's."""


def surfaces(device) -> Surface:
    return Surface(absorption=torch.full((1, 8), ABSORPTION, device=device),
                   scattering=torch.full((1, 8), SCATTERING, device=device))


def halls(device, small: bool = False):
    """{name: (soup on ``device``, a maker of its ray tables)} for the trace
    mode; the large hall cut to bench.py's CPU size when ``small``."""
    model = procedural_hall()[0].to(device)
    large = (procedural_hall_large(shell_div=30, n_columns=6) if small
             else procedural_hall_large())[0].to(device)

    def mt(soup, cull=None):
        return lambda: mk.build_mt_triangles(soup, cull=cull).to(device)

    return {"mt": (model, mt(model, cull=False)),
            "dense": (model, lambda: None),
            "grid": (model, lambda: ray_accel.build_ray_grid(model)
                     .to(device)),
            "large_b4": (large, mt(large, cull=True)),
            "large_all_pairs": (large, mt(large, cull=False))}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches():
    return {"ray_mt_closest": mk.mt_closest.launches,
            "ray_mt_closest_culled": mk.mt_closest.culled_launches}


def run_trace(soup, accel, *, num_rays, depth, seed, src=SRC, rcv=RCV):
    """(trace results, seconds) of one ``trace``, ended by a synchronise."""
    device = soup.vertices.device
    _sync(device)
    t0 = time.perf_counter()
    res = tracer.trace(soup, surfaces(device), src, rcv,
                       torch.Generator(device=device).manual_seed(seed),
                       num_rays=num_rays, depth=depth, max_time=1.0,
                       accel=accel)
    _sync(device)
    return res, time.perf_counter() - t0


def time_trace(name, soup, accel, *, num_rays=RAYS, depth=DEPTH, reps=2,
               seed=SEED):
    """One backend's row: the least seconds of ``reps`` traces after a
    one-bounce warm-up, the rate, the energy and the launches of one run."""
    run_trace(soup, accel, num_rays=num_rays, depth=1, seed=seed)
    secs = []
    for _ in range(reps):
        before = _launches()
        res, dt = run_trace(soup, accel, num_rays=num_rays, depth=depth,
                            seed=seed)
        secs.append(dt)
    after = _launches()
    energy = float(res.histogram.sum())
    return {"backend": name, "triangles": int(soup.triangles.shape[0]),
            "rays": num_rays, "bounces": depth, "seconds": min(secs),
            "all_seconds": secs,
            "ray_bounces_per_s": num_rays * depth / min(secs),
            "energy": energy,
            "launches": {k: after[k] - before[k] for k in after}}


# ---------------------------------------------------------------------------
# the kernels alone

def record_queries(soup, tris, src, rcv, keep, *, seed=KERNEL_SEED,
                   num_rays=RAYS):
    """The rays of a trace exactly as ``mt_closest`` gets them
    (``_kernel_rays``' output: excludes int32, and sorted rays and sorted ids
    for culled ``tris``).  A bounce makes two queries, the closest hit
    (number 2 * bounce) and the visibility of the receiver from the hit
    point (2 * bounce + 1), where a ray that has left the scene has a
    non-finite origin.  ``keep``: the numbers of the queries wanted; returns
    {number: (origin, direction, exclude)}."""
    kept, count = {}, [0]
    real = mk._kernel_rays

    def recording(*args):
        out = real(*args)
        if count[0] in keep:
            kept[count[0]] = out[:3]
        count[0] += 1
        return out

    bounces = max(keep) // 2 + 1
    mk._kernel_rays = recording
    try:
        run_trace(soup, tris, num_rays=num_rays, depth=bounces, seed=seed,
                  src=src, rcv=rcv)
    finally:
        mk._kernel_rays = real
    if count[0] != 2 * bounces or set(kept) != set(keep):
        raise RuntimeError(f"recorded {count[0]} ray queries, expected "
                           f"{2 * bounces}")
    return kept


def plain_with_tile_counts(tris, o, d, ex):
    """The plain version's result, and for each ray tile of ``mk.RB`` rays
    the number of triangle tiles whose arithmetic it ran (for the culled
    version: the tiles its sequential gate let through)."""
    counts = []
    blocks, tile = mk._ray_blocks, mk._mt_tile

    def counting_blocks(*args):
        for block in blocks(*args):
            counts.append(0)
            yield block

    def counting_tile(*args):
        counts[-1] += 1
        return tile(*args)

    plain = mk._closest_culled_plain if tris.culled else mk._closest_plain
    mk._ray_blocks, mk._mt_tile = counting_blocks, counting_tile
    try:
        out = plain(o, d, ex, tris)
    finally:
        mk._ray_blocks, mk._mt_tile = blocks, tile
    return out, counts


def tile_stats(counts, tiles: int):
    """The gate's work per ray tile: max, mean, min, the 10th … 90th
    percentiles, and how many ray tiles let through each tenth of the
    ``tiles`` triangle tiles (the last tenth includes all of them)."""
    c = np.asarray(counts, dtype=np.float64)
    hist = np.histogram(c, bins=10, range=(0, tiles))[0]
    return {"ray_tiles": len(counts), "triangle_tiles": tiles,
            "max": int(c.max()), "mean": float(c.mean()), "min": int(c.min()),
            "percentiles": [float(p) for p in np.percentile(
                c, np.arange(10, 100, 10))],
            "histogram_by_tenths": [int(h) for h in hist]}


def bound_us(rays: int, tris, tile_pairs=None):
    """(least µs of one launch, "bytes" or "operations").  Bytes: origin,
    direction, exclude in (28 B a ray), packed (and tile boxes) in, t and id
    out (8 B a ray).  B3's operations: MT_OPS_PER_PAIR on every (ray, real
    triangle) pair.  B4's: a slab test per (ray, triangle tile), and
    MT_OPS_PER_PAIR on every pair of the ``tile_pairs`` (ray tile, triangle
    tile) pairs that the plain version's gate let through."""
    n_bytes = 36 * rays + 4 * tris.packed.numel()
    if tris.culled:
        n_bytes += 4 * tris.tile_boxes.numel()
        ops = SLAB_OPS_PER_TILE * rays * tris.tile_boxes.shape[0] \
            + MT_OPS_PER_PAIR * mk.RB * mk.TB * tile_pairs
    else:
        ops = MT_OPS_PER_PAIR * rays * tris.num
    return roofline.bound_us(n_bytes, ops)


def instruction_estimate_us(pairs: int) -> float:
    """An estimate, not a bound: ``pairs`` (ray, triangle) pairs at
    INSTRUCTIONS_PER_PAIR instructions each, the card starting 128 a
    clock on each of its 132 SMs."""
    return 1e6 * INSTRUCTIONS_PER_PAIR * pairs / INSTRUCTIONS_PER_S


def device_time_us(fn, reps: int, device="cuda"):
    """µs of one ``fn()``: on the card by CUDA events over ``reps`` calls
    with the stream held by a spin kernel (twice ``reps`` synchronised calls
    long, at most 2 s) while the host enqueues them, so the events time the
    kernels back to back; on the CPU by the host's clock."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_us, 2e6) * 2000))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / reps


def time_once_us(fn, device="cuda"):
    """(µs, result) of one call: CUDA events on the card, the host's clock
    on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return 1e6 * (time.perf_counter() - t0), out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop), out


def compare(tag, what, tris, got, want, log=print):
    """A launch's (t, id) against the plain version's on the same rays;
    returns (max |t - t_plain|, share of rays that hit).  Raises
    ``Mismatch`` unless they are equal to the bit."""
    (t, i), (t_want, i_want) = got, want
    err = float((t - t_want).abs().max())
    ids_differ = int((i != i_want).sum())
    hits = float((t_want < mk.BIG).float().mean())
    name = "B4" if tris.culled else "B3"
    log(f"[{tag}] {name} {t.shape[0]} rays x {tris.num} triangles (Tpad "
        f"{tris.packed.shape[1]}; {what}): max |t - t_plain| = {err:.3e}, "
        f"{ids_differ} ids differ, {100 * hits:.1f}% of rays hit (gate: "
        "equal to the bit)")
    if not (err == 0.0 and ids_differ == 0 and torch.equal(t, t_want)
            and torch.equal(i, i_want)):
        raise Mismatch(f"{name} disagrees with its plain version: {what}")
    return err, hits


def edge_rays(tile, n, rng):
    """(origin, direction) of ``n`` rays on ``tile``'s device, aimed at
    points of the packed triangles ``tile`` (9, T) whose barycentrics lie on
    or just beyond the slack's edges (u or v = -1e-4, u + v = 1 + 1e-4, and
    one float either side), from random directions at random distances
    (``rng``: a numpy Generator)."""
    k = rng.integers(0, tile.shape[1], n)
    edge = np.array([-1e-4, 0.0, 1.0, 1.0 + 1e-4])
    u = rng.choice(edge, n) + rng.choice([-1, 0, 1], n) * 1e-7
    v = np.where(rng.random(n) < 0.5, rng.choice(edge, n),
                 1.0 + 1e-4 - u) + rng.choice([-1, 0, 1], n) * 1e-7
    c = tile.cpu().numpy().astype(np.float64)
    point = c[0:3, k].T + u[:, None] * c[3:6, k].T + v[:, None] * c[6:9, k].T
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = point - rng.uniform(0.01, 30.0, (n, 1)) * d
    return (torch.tensor(o, dtype=torch.float32, device=tile.device),
            torch.tensor(d, dtype=torch.float32, device=tile.device))


def skip_shares(o, d, tris, warp=32, chunk=4096):
    """What the scan's two warp-wide tests drop on these rays, in this order
    (``mt_kernels._skip_tests_plain``): of the (warp of ``warp`` consecutive
    rays, real triangle) pairs, the share in which no lane passes test 1,
    and the share in which no lane passes test 1 or none passes test 2 (the
    pairs that never reach the reciprocal).  Rays are padded to whole warps
    with zero rays, which pass neither test, as the kernels pad a block."""
    R = o.shape[0]
    pad = -R % warp
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    kept_u = torch.zeros((), dtype=torch.int64, device=o.device)
    kept_uv = torch.zeros_like(kept_u)
    for r0 in range(0, o.shape[0], chunk):
        oc, dc = o[r0:r0 + chunk], d[r0:r0 + chunk]
        for base in range(0, tris.num, mk.TB):
            tile = tris.packed[:, base:min(base + mk.TB, tris.num)]
            pass_u, pass_uv = mk._skip_tests_plain(oc, dc, tile)
            kept_u += pass_u.view(-1, warp, tile.shape[1]).any(1).sum()
            kept_uv += pass_uv.view(-1, warp, tile.shape[1]).any(1).sum()
    pairs = o.shape[0] // warp * tris.num
    return {"warp_triangle_pairs": pairs,
            "test1_drops": 1.0 - int(kept_u) / pairs,
            "test1_or_2_drops": 1.0 - int(kept_uv) / pairs}


def kernel_case(key, what, soup, tris, src, rcv, *, reps, plain=True,
                seed=KERNEL_SEED, num_rays=RAYS, timed_bounce=TIMED_BOUNCE,
                late_bounce=LATE_BOUNCE, tag="rays_timing", card="",
                log=print):
    """One kernel alone on a trace's rays: B3, or B4 for culled ``tris``.

    Times ``mt_closest`` on the closest-hit query of ``timed_bounce``.  With
    ``plain``, also times the plain version once (counting the triangle
    tiles each ray tile scanned), holds the kernel to it to the bit on that
    query and on the visibility query of ``late_bounce``, and returns their
    numbers beside the time, and for B4 the card's residency of its
    clusters; for B3 the skip tests' shares on both queries
    (``skip_shares``)."""
    device = soup.vertices.device
    timed, late = 2 * timed_bounce, 2 * late_bounce + 1
    queries = record_queries(soup, tris, src, rcv,
                             {timed, late} if plain else {timed}, seed=seed,
                             num_rays=num_rays)
    o, d, ex = queries[timed]
    k_us = device_time_us(lambda: mk.mt_closest(o, d, ex, tris), reps,
                          device)
    pairs = num_rays * tris.num
    out = {"key": key, "us": k_us, "shape": [num_rays, tris.packed.shape[1]],
           "plain_us": None, "tile_pairs_run": None, "max_abs_err": None,
           "tile_stats": None}
    line = (f"[{tag}] {key.upper()} alone, {num_rays} rays of bounce "
            f"{timed_bounce} x {tris.num} triangles (Tpad "
            f"{tris.packed.shape[1]}; {what}): kernel {k_us:.1f} us/launch "
            f"({num_rays / k_us:.4e} rays/us, "
            f"{MT_OPS_PER_PAIR * pairs / k_us / 1e6:.2f} TFLOP/s counted over "
            f"all pairs)")
    if not plain:
        out["bound"] = bound_us(num_rays, tris)
        log(line + f", bound {out['bound'][0]:.2f} us by {out['bound'][1]} "
            f"[{card}]")
        return out
    p_us, (want, counts) = time_once_us(
        lambda: plain_with_tile_counts(tris, o, d, ex), device)
    scanned = sum(counts)
    out["bound"] = bound_us(num_rays, tris, scanned)
    line += (f", bound {out['bound'][0]:.2f} us by {out['bound'][1]}, plain "
             f"version {p_us:.0f} us (one run)")
    out["plain_us"] = p_us
    if tris.culled:
        tiles = tris.tile_boxes.shape[0]
        tile_pairs = len(counts) * tiles
        out["tile_pairs_run"] = scanned / tile_pairs
        out["scanned_tile_pairs"] = scanned
        stats = out["tile_stats"] = tile_stats(counts, tiles)
        scanned_pairs = scanned * mk.RB * mk.TB
        out["instruction_estimate_us"] = instruction_estimate_us(
            scanned_pairs)
        all_pairs_us = 1e6 * MT_OPS_PER_PAIR * pairs \
            / roofline.F32_FLOP_PER_S
        line += (f"; the gate let {100 * out['tile_pairs_run']:.2f}% of "
                 f"{tile_pairs} (ray tile, triangle tile) pairs through "
                 f"({scanned_pairs:.4e} (ray, triangle) pairs; at "
                 f"{INSTRUCTIONS_PER_PAIR} instructions a pair the "
                 f"card needs about {out['instruction_estimate_us']:.0f} us, an "
                 f"estimate, not the bound); all pairs at the float32 rate "
                 f"would take {all_pairs_us:.1f} us (not the bound)")
        log(line + f" [{card}]")
        log(f"[{tag}] {key.upper()} gate per ray tile: {stats['ray_tiles']} "
            f"ray tiles, {tiles} triangle tiles; tiles scanned max "
            f"{stats['max']}, mean {stats['mean']:.2f}, min {stats['min']}; "
            f"10th-90th percentiles {stats['percentiles']}; ray tiles by "
            f"tenths of the triangle tiles {stats['histogram_by_tenths']}; "
            f"kernel time / max = {k_us / max(stats['max'], 1):.1f} us a "
            f"tile of the heaviest ray tile [{card}]")
    else:
        log(line + f" [{card}]")
    err, out["hits"] = compare(
        tag, f"{what}: the closest-hit query of bounce {timed_bounce}, the "
        "rays just timed", tris, mk.mt_closest(o, d, ex, tris), want, log)
    lo, ld, lex = queries[late]
    out["dead"] = int((~torch.isfinite(lo).all(dim=1)).sum())
    plain_fn = mk._closest_culled_plain if tris.culled else mk._closest_plain
    want_late = plain_fn(lo, ld, lex, tris)
    err_late, out["hits_late"] = compare(
        tag, f"{what}: the visibility query of bounce {late_bounce}, "
        f"{out['dead']} origins not finite", tris,
        mk.mt_closest(lo, ld, lex, tris), want_late, log)
    out["max_abs_err"] = max(err, err_late)
    out["late_us"] = device_time_us(lambda: mk.mt_closest(lo, ld, lex, tris),
                                    reps, device)
    log(f"[{tag}] {key.upper()} alone on the visibility query of bounce "
        f"{late_bounce}: kernel {out['late_us']:.1f} us/launch [{card}]")
    if not tris.culled:
        out["skip_shares"] = {}
        for query, (qo, qd), name in (
                ("closest", (o, d), f"closest-hit query of bounce "
                 f"{timed_bounce}"),
                ("visibility", (lo, ld), f"visibility query of bounce "
                 f"{late_bounce}")):
            sh = out["skip_shares"][query] = skip_shares(qo, qd, tris)
            log(f"[{tag}] {key.upper()} {name}: of "
                f"{sh['warp_triangle_pairs']} (warp, triangle) pairs test 1 "
                f"drops {100 * sh['test1_drops']:.2f}%, test 1 or 2 "
                f"{100 * sh['test1_or_2_drops']:.2f}% [{card}]")
    if device.type == "cuda":
        occ = out["occupancy"] = (mk.culled_occupancy if tris.culled
                                  else mk.closest_occupancy)(device)
        log(f"[{tag}] {key.upper()}: {occ['registers']} registers, "
            f"{occ['local_bytes']} B of local memory a thread, "
            f"{occ['ctas_per_sm']} CTAs an SM, {occ['clusters']} clusters "
            f"on the card at once [{card}]")
    return out


def kernel_cases(which: str, device, *, reps=None, num_rays=RAYS,
                 late_bounce=LATE_BOUNCE, small=False,
                 tag="rays_timing", card="", log=print):
    """The cases of ``--kernel b3`` (the model hall, and the large hall with
    ``cull=False``) or ``--kernel b4`` (the large hall, culled)."""
    model = procedural_hall()[0]
    large = (procedural_hall_large(shell_div=30, n_columns=6) if small
             else procedural_hall_large())[0]
    if which == "b3":
        cases = (("b3", "model hall", model, False, MODEL_SRC, MODEL_RCV,
                  reps or 50, True),
                 ("b3_large", "large hall, cull=False", large, False, SRC,
                  RCV, reps or 5, True))
    else:
        cases = (("b4", "large hall", large, True, SRC, RCV, reps or 20,
                  True),)
    return [kernel_case(key, what, soup.to(device),
                        mk.build_mt_triangles(soup, cull=cull).to(device),
                        src, rcv, reps=n, plain=plain, num_rays=num_rays,
                        late_bounce=late_bounce, tag=tag, card=card, log=log)
            for key, what, soup, cull, src, rcv, n, plain in cases]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wayverb_tpu_torch.tools.rays_timing",
        description="Time trace's ray backends, or B3/B4 alone.")
    p.add_argument("backends", nargs="*",
                   help="trace mode: any of mt dense grid large_b4 "
                        "large_all_pairs (default: all)")
    p.add_argument("--kernel", choices=("b3", "b4"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--rays", type=int)
    p.add_argument("--depth", type=int, default=DEPTH)
    p.add_argument("--reps", type=int)
    p.add_argument("--late-bounce", type=int, default=LATE_BOUNCE)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("rays_timing: needs a CUDA device (or --device cpu)")
    card = card_name_and_power_limit() if on_card else "cpu, host clock"
    print(card, flush=True)
    num_rays = args.rays or (RAYS if on_card else 1 << 10)
    if args.kernel:
        rows = kernel_cases(args.kernel, device, reps=args.reps,
                            num_rays=num_rays, late_bounce=args.late_bounce,
                            small=not on_card, card=card)
        for row in rows:
            print(json.dumps({**row, "device": card}), flush=True)
        return rows
    table = halls(device, small=not on_card)
    rows = []
    for name in args.backends or list(table):
        soup, build = table[name]
        row = time_trace(name, soup, build(), num_rays=num_rays,
                         depth=args.depth, reps=args.reps or 2)
        rows.append(row)
        print(json.dumps({**row, "device": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
