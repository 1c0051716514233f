"""Time the general mesh's kernels on x-walks on the columns hall's own
weight code: with ``--kernel b9`` the adjoint B9 at the whole hall, with
``--kernel b11`` the shard adjoint B11 and with ``--kernel b10`` the shard
step B10 at a shard of it.

    python -m wayverb_tpu_torch.tools.mesh_timing --kernel b9
    python -m wayverb_tpu_torch.tools.mesh_timing --kernel b11
    python -m wayverb_tpu_torch.tools.mesh_timing --kernel b10

On the card, at the columns hall (``procedural_hall(2, 4, 1)`` meshed at
the engine's rate for a 1500 Hz cutoff, as ``chip_smoke.py`` phase 19
meshes it: (343, 139, 259)), ``--kernel b9``:

* builds ``csrc/mesh_weighted_step_bwd.cu`` and prints ptxas's registers,
  stack and spills, and what the card makes of the kernel
  (``stencil_kernels.bwd_occupancy``; None on a tree that lacks it);
* counts the share of the kernel's warps that take its bare path on the
  hall's code (``bare_warps``);
* holds B9 to the bit against ``_weighted_step_bwd_plain`` on the hall's
  code (random g, g at 1e38 with ±inf and NaN, all −0) and on a random
  code;
* times B9 with the stream held, beside the wrapper's host µs a call, the
  plain version's µs, B8 (the forward step) at the same shape, and both
  bounds (``mesh_bounds``).

At the second of four x-shards of the columns hall (meshed as above with x
aligned to 4, as ``Engine(device_mesh=…)`` meshes it: a shard of (86, 139,
259)), ``--kernel b11``:

* builds ``csrc/mesh_weighted_step_haloed_bwd.cu`` and prints ptxas's
  registers, stack and spills, and what the card makes of the kernel
  (``stencil_kernels.shard_bwd_occupancy``: registers, local bytes, CTAs an
  SM, threads a CTA, CTAs a launch);
* counts the share of the kernel's warps (32 consecutive nodes of a row of
  the flattened (y, z) plane) that take its bare path on the shard's code
  (``bare_warps``);
* holds B11 to the bit against ``_weighted_step_sharded_bwd_plain`` in ĝcur
  and both halo cotangents (``bits_equal``: NaN where the plain version has
  NaN, the same bits everywhere else, so −0 and +0 differ), on the shard's
  own weight code and on a random code;
* times B11 with the stream held (``mega_timing.device_time_us``), beside
  the wrapper's host µs a call, the plain version's µs, B10 (the shard's
  forward) at the same shape, and both bounds (``tools/roofline.py``).

At the same shard, ``--kernel b10``:

* builds ``csrc/mesh_weighted_step_haloed.cu`` and prints ptxas's
  registers, stack and spills, and ``stencil_kernels.shard_fwd_occupancy``
  (None on a tree that lacks it);
* counts the share of the kernel's warps that take its bare path on the
  shard's code (``forward_bare_warps``: a warp whose 32 nodes have all six
  weights exactly 1 and the interior bit);
* holds B10 to the bit against ``_weighted_step_sharded_plain``, into a
  fresh output and into ``out=prev``, on the shard's code (random inputs,
  inputs at 1e38 with ±inf and NaN, all −0, a slice of Y·Z < 32, one and
  two rows) and on a random code;
* times B10 with the stream held, beside the wrapper's host µs a call, the
  plain version's µs, the bound and time / bound (``shard_bounds``); and
  a launch on each of the four shards in turn, each with its own fields
  and code, as a step of the sharded run launches it (the four shards'
  fields, ≈ 200 MB, do not stay in the 50 MB L2 from one launch to the
  next).

One JSON line, after the card's name and power limit.  Without a card it
fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wayverb_tpu_torch.tools import roofline

COLUMNS_CUTOFF = 1500.0     # chip_smoke.py's columns hall
SHARDS = 4
ABSORPTION = 0.1
SEED = 20261017
REPS = 200


def mesh_bounds(dims) -> dict:
    """{kernel: (µs, "bytes" or "operations")} of one step on a grid of
    ``dims`` (``chip_smoke.py`` reports them too).  B8: cur, prev and the
    int32 code in, out out; 6 multiplies and 6 adds, then two multiplies
    and a subtract a node.  B9: g and the code in, ĝcur out; 6 multiplies, 6
    adds and a multiply a node.  B12: cur, prev and the mask in, out out; 6
    adds, a multiply, a subtract and a multiply a node."""
    n = dims[0] * dims[1] * dims[2]
    return {"b8": roofline.bound_us(16 * n, 15 * n),
            "b9": roofline.bound_us(12 * n, 13 * n),
            "b12": roofline.bound_us(16 * n, 9 * n)}


def shard_bounds(dims) -> dict:
    """{kernel: (µs, "bytes" or "operations")} of one launch on a shard of
    ``dims`` (``chip_smoke.py`` reports them too).  B10: cur, prev, the
    int32 code and the two halo rows in, out out; 15 operations a node.
    B11: g and the code in, ĝcur and the two halo rows out; 13 operations a
    node and two multiplies a halo element."""
    X, Y, Z = dims
    n, row = X * Y * Z, Y * Z
    return {"b10": roofline.bound_us(4 * (4 * n + 2 * row), 15 * n),
            "b11": roofline.bound_us(4 * (3 * n + 2 * row), 13 * n + 4 * row)}


def bits_equal(a, b) -> bool:
    """Whether two float tensors agree to the bit, NaN for NaN (the payload
    aside): ``torch.equal`` holds −0 equal to +0."""
    nan = torch.isnan(a)
    if a.shape != b.shape or not torch.equal(nan, torch.isnan(b)):
        return False
    return bool(torch.equal(torch.where(nan, 0, a.view(torch.int32)),
                            torch.where(nan, 0, b.view(torch.int32))))


def case_g(what: str, shape, gen):
    """g of a bit-equality case, on ``gen``'s device: ``"random"`` normal,
    ``"1e38 inf nan"`` normal × 1e38 with ±inf and NaN sprinkled in (sums
    that overflow, 0·inf at weight-0 neighbours), or ``"all -0"``."""
    if what == "all -0":
        return torch.full(shape, -0.0, device=gen.device)
    g = torch.randn(*shape, generator=gen, device=gen.device)
    if what == "1e38 inf nan":
        g = g * 1e38
        flat = g.view(-1)
        flat[::7], flat[::11], flat[::13] = (float("inf"), float("-inf"),
                                             float("nan"))
    elif what != "random":
        raise ValueError(f"case_g: no case {what!r}")
    return g


def columns_code(device="cuda", cutoff: float = COLUMNS_CUTOFF, align=None):
    """The int32 weight code of the columns hall meshed for ``cutoff`` Hz:
    as ``chip_smoke.py`` phase 19 meshes it with ``align`` None, as
    ``Engine(device_mesh=…)`` does with ``(SHARDS, 1, 1)``."""
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    fs = cutoff / (0.25 * 0.6)
    mesh = wgrun.compute_mesh(procedural_hall(2, 4, 1)[0],
                              np.full((1, 8), ABSORPTION),
                              grid_spacing(340.0, 1.0 / fs), fs,
                              align=align, device=device)
    return mesh.structure.weight_code


def columns_shard_code(device="cuda", shard: int = 1,
                       cutoff: float = COLUMNS_CUTOFF):
    """The int32 weight code of x-shard ``shard`` of the columns hall
    meshed for ``cutoff`` Hz and split in ``SHARDS``, as ``chip_smoke.py``
    phase 29 takes it (the tests take it at 400 Hz)."""
    code = columns_code(device, cutoff, align=(SHARDS, 1, 1))
    xl = code.shape[0] // SHARDS
    return code[shard * xl:(shard + 1) * xl].contiguous()


def bare_warps(code):
    """Which warps of B9 and B11 take their bare path: (X, ⌈Y·Z/32⌉) bool,
    warp s of row x holding the nodes p = 32·s … 32·s + 31 of the flattened
    (y, z) plane (``csrc/mesh_adjoint.cuh``); true where all 32 exist and
    each sees six neighbours in the grid whose codes give all six weights
    exactly 1.  Those warps sum g without decoding."""
    X, Y, Z = code.shape
    one = (code & 0xFFF) == 0x3F
    node = torch.zeros_like(one)
    node[1:-1, 1:-1, 1:-1] = (one[:-2, 1:-1, 1:-1] & one[2:, 1:-1, 1:-1]
                              & one[1:-1, :-2, 1:-1] & one[1:-1, 2:, 1:-1]
                              & one[1:-1, 1:-1, :-2] & one[1:-1, 1:-1, 2:])
    warps = -(-Y * Z // 32)
    flat = torch.zeros((X, 32 * warps), dtype=torch.bool, device=code.device)
    flat[:, :Y * Z] = node.reshape(X, Y * Z)
    return flat.reshape(X, warps, 32).all(-1)


def forward_bare_warps(code, threads: int):
    """Which warps of B10 take its bare path: (X, warps) bool, warp s of
    row x holding the nodes p = 32·s … 32·s + 31 of the flattened (y, z)
    plane, over the ⌈Y·Z/threads⌉ CTAs of ``threads`` a row the kernel
    launches (``csrc/mesh_step_walk.cuh``); true where all 32 exist and
    each node's own code has all six weights exactly 1 and bit 12 set.
    Those warps sum without decoding."""
    if threads % 32:
        raise ValueError(f"forward_bare_warps: {threads} threads is not a "
                         "whole number of warps")
    X, Y, Z = code.shape
    node = (code & 0x1FFF) == 0x103F
    lanes = -(-Y * Z // threads) * threads
    flat = torch.zeros((X, lanes), dtype=torch.bool, device=code.device)
    flat[:, :Y * Z] = node.reshape(X, Y * Z)
    return flat.reshape(X, lanes // 32, 32).all(-1)


def b10_inputs(what: str, dims, gen):
    """(cur, prev, (hlo, hhi)) of a B10 case, each made by ``case_g``."""
    halo = (1, *dims[1:])
    return (case_g(what, dims, gen), case_g(what, dims, gen),
            (case_g(what, halo, gen), case_g(what, halo, gen)))


def b10_equal(cur, prev, code, halos) -> dict:
    """B10 and its plain version on (cur, prev, code, halos), into a fresh
    output and into ``out=prev`` (a copy): bit-equality of both and the
    largest |kernel − plain|."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    want = sk._weighted_step_sharded_plain(cur, prev, code, halos)
    got = sk.weighted_step_sharded(cur, prev, code, halos)
    buf = prev.clone()
    sk.weighted_step_sharded(cur, buf, code, halos, out=buf)
    torch.cuda.synchronize()
    return {"equal": bits_equal(got, want), "equal_out_prev":
            bits_equal(buf, want),
            "max_abs_err": float((got - want).abs().nan_to_num().max())}


def b9_equal(g, code) -> dict:
    """B9 and its plain version on (g, code): bit-equality and the largest
    |kernel − plain|."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    got = sk.weighted_step_bwd(g, code)
    want = sk._weighted_step_bwd_plain(g, code)
    torch.cuda.synchronize()
    return {"equal": bits_equal(got, want),
            "max_abs_err": float((got - want).abs().nan_to_num().max())}


def b11_equal(g, code) -> dict:
    """B11 and its plain version on (g, code): bit-equality and the largest
    |kernel − plain| of ĝcur and each halo cotangent."""
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    got = sk.weighted_step_sharded_bwd(g, code)
    want = sk._weighted_step_sharded_bwd_plain(g, code)
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(("gcur", "ghlo", "ghhi"), (got[0], *got[1]),
                          (want[0], *want[1])):
        out[name] = {"equal": bits_equal(a, b),
                     "max_abs_err": float((a - b).abs().nan_to_num().max())}
    return out


def main_b11() -> dict:
    """The ``--kernel b11`` mode: one JSON line."""
    from wayverb_tpu_torch.tools.mega_timing import (device_time_us,
                                                     ptxas_lines)
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    t0 = time.perf_counter()
    ptxas = ptxas_lines("mesh_weighted_step_haloed_bwd")
    code = columns_shard_code()
    dims = tuple(code.shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    g = rnd(*dims)
    random_code = torch.randint(0, 1 << 13, dims, generator=gen,
                                device="cuda", dtype=torch.int32)
    checks = {"hall": b11_equal(g, code),
              "random": b11_equal(g, random_code)}
    us, host_us = device_time_us(
        lambda: sk.weighted_step_sharded_bwd(g, code), REPS)
    plain_us, _ = device_time_us(
        lambda: sk._weighted_step_sharded_bwd_plain(g, code), 20)
    cur, prev = rnd(*dims), rnd(*dims)
    halos = (rnd(1, *dims[1:]), rnd(1, *dims[1:]))
    out = torch.empty_like(cur)
    b10_us, _ = device_time_us(lambda: sk.weighted_step_sharded(
        cur, prev, code, halos, out=out), REPS)
    bounds = shard_bounds(dims)
    equal = all(c["equal"] for case in checks.values() for c in case.values())
    row = {"kernel": "b11", "shape": list(dims), "ptxas": ptxas,
           # trees before the redesign (a parent checked beside it) have
           # no occupancy query
           "occupancy": (sk.shard_bwd_occupancy(dims=dims)
                         if hasattr(sk, "shard_bwd_occupancy") else None),
           "bare_warp_share": float(bare_warps(code).float().mean()),
           "equal_plain": equal, "checks": checks, "us_per_launch": us,
           "host_us_per_call": host_us,
           "plain_us": plain_us, "bound_us": bounds["b11"][0],
           "bound_by": bounds["b11"][1],
           "time_over_bound": us / bounds["b11"][0],
           "b10_us_per_launch": b10_us, "b10_bound_us": bounds["b10"][0],
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not equal:
        raise SystemExit("mesh_timing: B11 differs from its plain version")
    return row


def main_b10() -> dict:
    """The ``--kernel b10`` mode: one JSON line."""
    from wayverb_tpu_torch.tools.mega_timing import (device_time_us,
                                                     ptxas_lines)
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    t0 = time.perf_counter()
    ptxas = ptxas_lines("mesh_weighted_step_haloed")
    full = columns_code(align=(SHARDS, 1, 1))
    xl = full.shape[0] // SHARDS
    shards = [full[s * xl:(s + 1) * xl].contiguous() for s in range(SHARDS)]
    code = shards[1]
    dims = tuple(code.shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    random_code = torch.randint(0, 1 << 13, dims, generator=gen,
                                device="cuda", dtype=torch.int32)
    cases = {f"hall, {what}": (code, what)
             for what in ("random", "1e38 inf nan", "all -0")}
    cases.update({
        "hall, Y*Z < 32": (code[:4, 60:63, 100:105].contiguous(), "random"),
        "hall, one row": (code[40:41].contiguous(), "random"),
        "hall, two rows": (code[40:42].contiguous(), "random"),
        "random code": (random_code, "random")})
    checks = {}
    for name, (c, what) in cases.items():
        cur, prev, halos = b10_inputs(what, tuple(c.shape), gen)
        checks[name] = b10_equal(cur, prev, c, halos)
    cur, prev, halos = b10_inputs("random", dims, gen)
    out = torch.empty_like(cur)
    us, host_us = device_time_us(lambda: sk.weighted_step_sharded(
        cur, prev, code, halos, out=out), REPS)
    plain_us, _ = device_time_us(
        lambda: sk._weighted_step_sharded_plain(cur, prev, code, halos), 20)
    steps = [(*b10_inputs("random", dims, gen), c, torch.empty_like(cur))
             for c in shards]

    def step():
        for c_, p_, h_, k_, o_ in steps:
            sk.weighted_step_sharded(c_, p_, k_, h_, out=o_)

    step_us, _ = device_time_us(step, REPS // SHARDS)
    bounds = shard_bounds(dims)
    # trees before the redesign (a parent checked beside it) have no
    # occupancy query
    occ = (sk.shard_fwd_occupancy(dims=dims)
           if hasattr(sk, "shard_fwd_occupancy") else None)
    threads = occ["threads"] if occ else 256
    equal = all(c["equal"] and c["equal_out_prev"] for c in checks.values())
    row = {"kernel": "b10", "shape": list(dims), "ptxas": ptxas,
           "occupancy": occ,
           "bare_warp_share": float(
               forward_bare_warps(code, threads).float().mean()),
           "equal_plain": equal, "checks": checks, "us_per_launch": us,
           "us_per_launch_four_shards": step_us / SHARDS,
           "host_us_per_call": host_us,
           "plain_us": plain_us, "bound_us": bounds["b10"][0],
           "bound_by": bounds["b10"][1],
           "time_over_bound": us / bounds["b10"][0],
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not equal:
        raise SystemExit("mesh_timing: B10 differs from its plain version")
    return row


def main_b9() -> dict:
    """The ``--kernel b9`` mode: one JSON line."""
    from wayverb_tpu_torch.tools.mega_timing import (device_time_us,
                                                     ptxas_lines)
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    t0 = time.perf_counter()
    ptxas = ptxas_lines("mesh_weighted_step_bwd")
    code = columns_code()
    dims = tuple(code.shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    random_code = torch.randint(0, 1 << 13, dims, generator=gen,
                                device="cuda", dtype=torch.int32)
    checks = {f"hall, {what}": b9_equal(case_g(what, dims, gen), code)
              for what in ("random", "1e38 inf nan", "all -0")}
    checks["random code"] = b9_equal(case_g("random", dims, gen),
                                     random_code)
    g = case_g("random", dims, gen)
    us, host_us = device_time_us(lambda: sk.weighted_step_bwd(g, code), REPS)
    plain_us, _ = device_time_us(
        lambda: sk._weighted_step_bwd_plain(g, code), 20)
    cur, prev = (case_g("random", dims, gen) for _ in range(2))
    out = torch.empty_like(cur)
    b8_us, _ = device_time_us(
        lambda: sk.weighted_step(cur, prev, code, out=out), REPS)
    bounds = mesh_bounds(dims)
    equal = all(c["equal"] for c in checks.values())
    row = {"kernel": "b9", "shape": list(dims), "ptxas": ptxas,
           # trees before the redesign (a parent checked beside it) have
           # no occupancy query
           "occupancy": (sk.bwd_occupancy(dims=dims)
                         if hasattr(sk, "bwd_occupancy") else None),
           "bare_warp_share": float(bare_warps(code).float().mean()),
           "equal_plain": equal, "checks": checks, "us_per_launch": us,
           "host_us_per_call": host_us,
           "plain_us": plain_us, "bound_us": bounds["b9"][0],
           "bound_by": bounds["b9"][1],
           "time_over_bound": us / bounds["b9"][0],
           "b8_us_per_launch": b8_us, "b8_bound_us": bounds["b8"][0],
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not equal:
        raise SystemExit("mesh_timing: B9 differs from its plain version")
    return row


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wayverb_tpu_torch.tools.mesh_timing",
        description="Time a general-mesh kernel on x-walks on the columns "
                    "hall's weight code: B9 at the hall, B10 and B11 at a "
                    "shard.")
    p.add_argument("--kernel", choices=("b9", "b10", "b11"), default="b11")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_timing: needs a CUDA device")
    from wayverb_tpu_torch.tools.probe_resident import \
        card_name_and_power_limit
    print(card_name_and_power_limit(), flush=True)
    return {"b9": main_b9, "b10": main_b10, "b11": main_b11}[args.kernel]()


if __name__ == "__main__":
    main()
