#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``wayverb_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port through its public entry points on the card and fails
(non-zero exit, no result line) on any error:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the port from ``wayverb_tpu_torch/csrc``,
   one nvcc per source, all started together;
3. B1 (the fused step) against its plain PyTorch version on the same CUDA
   tensors, to the bit in ``next`` and the six inner planes: 18 cases, the
   injection modes, sources on inner planes, on each side of a y and a z
   edge of the CTAs and warps, in a shard's first and last rows, shards of
   two rows and of the sharded hall's shape with halos, 1e38 inputs;
4. T30 oracle through the fused path: a 2.0×2.5×3.0 m box against Sabine,
   against the port's plain CPU run of its first 0.5 s, then ``postprocess``;
5. a concert-hall shoebox of 12.8 M nodes for 1024 fused steps
   (``run_waveguide_box``), with the launch count, step time, node-update
   rate and peak memory; B1 alone at the hall and at the sharded hall's
   shard shape with halos, timed with the stream held, beside the
   wrapper's host time, its bound, registers, local bytes and CTAs an SM;
   and a profiler breakdown of a step (device busy µs, idle share);
6. B2 (the mega chunk, K = 128) against its plain version at three shapes,
   the hall one with the hall's source and receiver taps, to the bit;
7. the mega path (``canonical``) against the fused path on the hall, with
   B2's time per sub-step, its registers, spills and CTAs an SM, one
   profiled chunk (one kernel launch), the launch counts of both kernels
   and the phase's wall;
8. T30 through the mega path;
9. the hybrid engine end to end: ``Engine.run`` + ``render`` and
   ``render_all`` on a hybrid hall, with the seconds of each phase; then B2
   against its plain version on the engine's own mesh, filter coefficients,
   source and receiver taps, to the bit; the phase's wall;
10. the hybrid engine on the card against the same run on the CPU, with the
    same random draws;
11. B5 (the fused step's adjoint) against its plain version to the bit
    (``bits_equal``: −0 apart from +0) at the seven shapes of phase 3, on
    1e38 / ±inf / NaN cotangents and on all −0 at the hall, and its time at
    the hall with the stream held, beside the wrapper's host time, its
    registers, local bytes, CTAs an SM and its warps' paths;
12. B6 (the grad-mode chunk: B2's outputs plus the residual block, to the
    bit) and B7 (the chunk's adjoint, K = 128) against their plain versions
    at three shapes, the hall from random state among them, the error per
    output and per plane, and their times per sub-step with B6's and B7's
    registers, spills and CTAs an SM, and the two streamed figures of B7
    (four fields, and the two-field form the kernel runs);
13. the gradient path at full width: the hall, 640 steps, value and gradient
    of Σ taps² with respect to the filter coefficients and the source
    signal through ``mega_canonical_loss_fn``, with the seconds of the
    forward and of the backward, the peak memory and the launch counts;
    then the same run again (warm allocator) and with only the signal
    requiring grad, for their seconds; one run under the profiler, whose
    backward chunks must be as many device launches of B7's one kernel;
    the phase's wall;
14. the two gradient routes on the card: the mega route (B6, B7) against
    ``run_waveguide_box(kernel_inject=False)`` (B1, B5) on the hall, 16
    steps, with the source beside a wall so the boundary filters matter;
15. gradients on the card against the plain versions on the CPU;
16. three gradient steps on a scale of the filter numerators toward a target
    response lower the loss each time;
17. B8, B9 and B12 (the general mesh's weighted step, its adjoint and the
    masked interior step) against their plain versions at odd dims, at
    tile-like dims and at the full shape of a hall with columns, with random
    13-bit codes and with that hall's own ``weight_code`` and
    ``interior_mask``; B9 to the bit, on the hall's own code also at 1e38
    with ±inf and NaN, all −0, and slices of Y·Z < 32, of one and two rows
    and of odd Y;
18. their times at that shape, and their plain versions'; B9's registers,
    local bytes, CTAs an SM and the share of its warps on the bare path;
19. the columns hall (``raytracer.scenes.procedural_hall(2, 4, 1)``, 96
    triangles, about 11.8 M nodes at a 1500 Hz cutoff) built as a general
    mesh and run through ``canonical`` for 1000 steps: one B8 launch per
    step, the seconds of each setup stage, step time, node-update rate, peak
    memory and a profiler breakdown of a step;
20. the T30 box built as a general mesh (no ``scene_box``) against Sabine
    and against the mega path; a box two nodes thin through the region path
    (B12) against its CPU run, and B12 against its plain version at that
    box's shape and mask;
21. the hybrid engine on the columns hall (no ``scene_box``): ``Engine.run``
    + ``render`` + ``render_all``, with the seconds of each phase; then card
    against CPU on the small columns hall;
22. the general gradient: value and gradient of Σ taps² in the filter
    coefficients on the columns hall, 64 steps checkpointed every 16, the
    source three nodes from a column (B9 in the backward), and a profiler
    breakdown of a forward + backward step with B9's device time in it, and
    the device time a step of the backward's eager −bit12·g (profiled alone
    as many times); then card against CPU on the small columns hall;
23. B3 and B4 (the closest ray–triangle hit over all triangles, and behind
    the Morton-tile gate) against their plain versions, to the bit: 100, 512,
    700 and 4,096 rays on 3 (fewer than B3's cluster has shares) to 20,000
    triangles, with and without excludes, rays that all miss, a triangle
    list held three times (equal t, and excludes, in other CTAs' shares of
    B3's cluster; the lowest id wins wherever the plain version says so),
    then the model hall's and the large hall's own tables, also with
    origins that are not finite; then B3 on 1,500 rays (a ragged second
    block) and on rays on the slack's edges of the model hall;
24. their times at 65,536 rays of a real bounce: B3 at the model hall
    (``raytracer.scenes.procedural_hall()``, 5,448 triangles), B4 and B3 at
    the large hall (``procedural_hall_large()``, 97,068 triangles), and the
    plain versions', whose results B3 and B4 must equal to the bit at these
    shapes, the main paths' own: on the rays just timed and on a later
    bounce's visibility query, where some rays have left the scene; the
    triangle tiles B4's gate lets through per 512-ray tile; B3's and B4's
    registers, spills and residency, and for B3 the share of (warp,
    triangle) pairs its skip tests drop, with the rays in the tracer's order
    (the ``--kernel`` mode of ``python -m
    wayverb_tpu_torch.tools.rays_timing``);
25. the model hall end to end: written with ``save_obj``, read back with
    ``load_scene``, ``Engine`` without ``scene_box`` (``auto_accel`` gives
    the MT kernels), ``run`` + ``render`` + ``render_all``, with the seconds
    of setup and of each phase, the trace's rate and the peak memory;
26. the large hall through ``trace`` with the culled kernel, 40 bounces, and
    again with ``cull=False``;
27. the voxel DDA on the card on the model hall, 40 bounces, and one bounce's
    closest hits against B3's;
28. a small hall above 100 triangles through ``Engine.run`` + ``render``
    (2,048 rays, absorption 0.2): the MT kernel on the card against the
    DDA on the CPU, same draws;
29. the sharded waveguide on one card, four x-shards of ``cuda:0``:
    ``Engine(device_mesh=…)`` builds the columns hall with x aligned to the
    shard count, (344, 139, 259); B10 and B11 (the weighted step of one
    x-shard with its halo rows, and its adjoint with the halo cotangents)
    against their plain versions at the shard shape (86, 139, 259), at one
    and two rows and at odd (Y, Z), with non-zero halos, both to the bit,
    B10 also into ``out=prev`` (and at 1e38 with ±inf and NaN, all −0,
    Y·Z < 32, one and two rows, on the hall's own shard code), and their
    times against their bounds; the registers, local bytes, CTAs an SM and
    the share of warps on the bare path of each;
30. that hall through ``run_waveguide_general_sharded``, 1000 steps (4000
    B10 launches), against the single-device B8 run on the same mesh, with
    the wall ms/step of both, the peak memory and a profiled window;
31. the sharded general gradient, 32 steps, B11 in the backward, against
    the single-device gradient; the device time of the forward, the
    backward and B11 in one more gradient under the profiler, beside the
    walls;
32. ``Engine(device_mesh=…).run`` + ``render`` (500 waveguide steps)
    against a single-device engine on the same mesh, same draws, with the
    seconds of each phase;
33. the shoebox hall (224, 224, 256) through ``run_waveguide_box_sharded``
    on four shards (B1 with real halos), 128 steps against the single-device
    fused run, then 32 steps from near a wall with
    ``state_dtype=torch.float64`` against the single-device fused run with
    the same state dtype, a 16-step gradient (B5 with halo cotangents, its
    launches counted), and B5 alone at the shard shape (56, 224, 256) with
    its bound;
34. ``sharded_trace`` on four shards: the direct energy against 8/(4πr²);
35. the residency probe: P1 (``tools.probe_resident``, K bare leapfrog
    sub-steps in one launch) against its plain version to the bit in every
    form: on one cluster (the T30 box's grid, (12, 9, 7), K = 1 too), on a
    cooperative grid of clusters (the worked placement (64, 224, 256) in
    clusters of 2, even and odd K, and tiles cut in x, y and z) and in
    device memory (above 50 MB too); its registers, local bytes, CTAs an
    SM, cluster size and clusters resident at once in each form; a
    resident grid too large for shared memory refused before any launch;
    then the sweep of ``python -m wayverb_tpu_torch.tools.probe_resident``
    (µs a sub-step by shape, mode and K) with its launches counted;
36. every capsule, every band: phase 9's hall with
    ``WaveguideParameters(bands=4)`` and per-band absorption through
    ``Engine.run`` (one ``canonical`` a band, 4 x 8 B2 launches), with the
    seconds of each phase and of each band, the peak memory against one
    band's run at the same absorption (at most 1.1x), every band finite and
    stable, the bands contiguous and their late energy falling as
    absorption rises; then
    ``render_all`` with ``Null``, ``Microphone(0.5)`` and both ears of
    ``Hrtf``;
37. the multiband engine (``bands=2``) on the test_combined box, card
    against CPU with the same draws, rendered with ``Hrtf(channel=0)`` and
    ``Null``, at phase 10's absorption and at the multiband hall's, both
    within phase 10's bounds; the ray leg's three-vector ops card against
    CPU on 2^20 random vectors (the library's reductions and
    ``core.geometry``'s ``dot3``, ``norm3``, ``sqrt32``, which must agree
    to the bit); at the low absorption the two traces behind
    the stochastic tail, over half the engine's bounces, split by ray
    (histograms bin by bin, the card's
    also against a second card trace of the same rays, the share of
    rays whose triangle history agrees, those rays' histograms, tails and
    reflection points alone, where the others first part);
    ``Hrtf.attenuation`` on 65,536 directions, card against CPU to the
    bit; ``canonical_multiband`` on four shards of ``cuda:0`` on the
    shoebox hall, 2 bands x 32 steps, against the single-device run;
38. resume and cancel on the hall (224, 224, 256), run while phases 5-7's
    mesh is built: 256 steps through ``run_cancellable`` in chunks of 64,
    cancelled after two chunks and resumed from ``Cancelled.state``, saved
    at step 128 with ``save_state`` and loaded back onto the card, and
    ``iter_pressure_fields(every=64)``: each bit-equal to one
    ``run_waveguide_box`` (256 B1 launches in each form), with the ms a
    chunk, the seconds and bytes of the save and the load, and against
    ``execute`` (B2);
39. the columns hall (B8, 100 steps as 4 x 25, run while phases 17-22's
    mesh is built) and phase 20's thin box (B12, 150 steps as 3 x 50)
    chunked against one run, to the bit;
40. phase 9's hall as a project file: one source x two receivers x omni,
    cardioid and both ears of ``Hrtf``, saved, loaded and rendered by
    ``run_project`` into 8 WAV files, each read back; the first pair again
    through ``Engine.run`` + ``render`` with the same generator seed, its
    renders under ``profiler_trace``, equal to the bit;
41. several processes, run right after phase 32: two ranks spawned as
    ``python chip_smoke.py --rank R --world 2 --port P --out DIR``, gloo,
    both on cuda:0 (NCCL refuses two ranks on one card), two shards each
    through ``distributed.global_device_mesh``: the shoebox hall 64 steps
    and phase 33's 16-step gradient (B1, B5), the columns hall 100 steps
    and phase 31's 32-step gradient checkpointed every 16 (B10, B11), and
    phase 29's engine, loaded with the global mesh, run + render at phase
    32's settings under the deterministic algorithms; each forward equal
    at 0.0 and each gradient within 1e-5 of the largest component of the
    one-process ``["cuda:0"] * 4`` run, both ranks' IRs equal to the bit,
    the band equal to phase 32's; ms/step beside the one-process mesh's,
    the bytes a rank exchanges a step, the seconds of staging and waiting,
    each rank's B1, B5, B10 and B11 launches; a rank that exits non-zero
    or outlives 420 s fails the phase (phase 37 also holds the image
    sources card against CPU: impulses and capsules to the bit, the head
    within 1e-6 of its peak, with its deposit and mixdown apart);
42. the eight waveguide validation tools of ``wayverb_tpu_torch/tools`` at
    the reference's defaults through ``main()`` on the card: each one's
    report, its own flags (``stable``, ``all_decaying``) gated, and B2
    launched by the four that run ``canonical``;
43. the last eight tools of ``wayverb_tpu_torch/tools`` on the card
    through ``main()``: ``box``, ``diffuse_decay`` and
    ``boundary_fit_sweep`` at the reference's defaults, ``longrun --mode
    hw`` at 12,000 steps of the hall (exactly 12,000 B1 launches, stable,
    the tail below the peak), ``longrun --mode f64 --steps 2000``,
    ``crackly_tunnel`` (B2), ``bake_hrtf`` on a synthesised set,
    ``visualize`` (B1; every PNG decoded to its size) and the GUI served on
    port 0, one render through HTTP (status ``done``, B2, B1 for the
    wavefront, the WAV read back) and a cancel; ``box`` again with
    ``--cpu`` from the same directions, its impulses bit-equal and its IR
    within 1e-6 of peak; each tool's seconds, launches, flags and report;
44. the forward half of the reference's ``tools/bench/mega_check.py``: a
    directional receiver 8 nodes off a centre impulse on the hall (224,
    224, 256), absorption 0.12, fs 3333.33 Hz, 128 steps through
    ``run_waveguide_box`` (exactly 128 B1 launches) and
    ``run_waveguide_box_mega(chunk=64)`` (exactly 2 B2 launches), each
    output within 5e-4 of its peak, both routes stable;
45. one JSON line of per-kernel results (B1, B5, B10 and B11 with
    ``distributed_launches``, each rank's; B1 and B2 with the last tools'
    ``tool_launches``), then the last line,
    ``{"ok": true, "device": {...}}``.

Every phase prints its wall as ``[N name] phase wall … s``.

A kernel's ``bound_ms`` is the least time the card could take for the same
function: the larger of its inputs and outputs moved once at 3.35 TB/s and
its float32 operations at 67 TFLOP/s (NVIDIA's figures for the H100 SXM).
For a chunk kernel that is the chunk's state in and out, as if the fields
stayed on chip between sub-steps.  Phase 12 also prints, outside the JSON
line and not as a bound, the same reckoning with the fields streamed through
device memory every sub-step, which is what a field larger than the 50 MB L2
forces.  B3's operations are those of the Möller–Trumbore arithmetic (its
compares and selects not counted) on every (ray, real triangle) pair; B4's
are the slab tests and that arithmetic on every pair of the (ray tile,
triangle tile) pairs that the plain version's sequential gate lets through
on the timed rays.  Phase 24 also prints, not as a bound, an estimate of
the time those pairs need at about 70 instructions each (with
--fmad=false nothing contracts; the compares, selects and the IEEE
reciprocal's sequence count too), and the all-pairs figure.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the engine's mesh rate at a 500 Hz cutoff, usable portion 0.6
# (compute_sampling_frequency), so the hall of phases 5-7 is the mesh that
# Engine.run builds in phase 9
FS = 500.0 / (0.25 * 0.6)
ABSORPTION = 0.1
SEED = 20261016
MEGA_VS_FUSED_REL = 1e-4    # mega vs fused path over 1024 steps, of peak
HYBRID_REL = 1e-3           # hybrid IR card vs CPU, of peak
BWD_REL = 1e-5             # B6 residuals, B7 vs plain, of the largest
GRAD_REL = 1e-4            # gradients between routes and card vs CPU
CHUNK = 128
GRAD_STEPS = 640           # the hall's backward workload: 5 chunks
KERNELS = ("box_fused_step", "box_mega_chunk", "box_fused_step_bwd",
           "box_mega_chunk_bwd", "mesh_weighted_step",
           "mesh_weighted_step_bwd", "mesh_interior_step", "ray_mt_closest",
           "ray_mt_closest_culled", "mesh_weighted_step_haloed",
           "mesh_weighted_step_haloed_bwd", "probe_resident")
MESH_REL = 1e-5            # B8, B9, B12 vs plain, per unit of peak
GENERAL_VS_MEGA_REL = 2e-5  # general path vs mega path on the T30 box
WAVEGUIDE_REL = 1e-4       # waveguide card vs CPU, of peak
# the columns hall: the engine's mesh rate at a 1500 Hz cutoff (10 kHz)
COLUMNS_CUTOFF = 1500.0
COLUMNS_FS = COLUMNS_CUTOFF / (0.25 * 0.6)
COLUMNS_SRC, COLUMNS_RCV = (6.0, 4.0, 5.0), (7.5, 3.0, 6.5)
COLUMNS_STEPS = 1000
SHARDED_ENGINE_STEPS = 500  # the sharded engine's waveguide (phases 32, 41)
SMALL_COLUMNS_CUTOFF = 400.0
# the ray leg: B3 and B4 equal their plain versions to the bit
RAYS = 1 << 16
MT_T_RTOL = 1e-5           # the DDA's t against B3's, on ...
MT_T_SHARE = 0.999         # ... this share of the rays (grazing rays: a
#                            small determinant amplifies float32 rounding)
MT_ID_SHARE = 0.98         # the share of equal triangle ids (shared edges)
LATE_BOUNCE = 20           # a bounce by which some rays of a trace have died
LARGE_SRC, LARGE_RCV = (2.0, 1.7, 3.0), (6.0, 1.9, 9.0)
LARGE_BOUNCES = 40


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: {msg}")


def phase_device(torch):
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import wayverb_tpu_torch
    pkg = os.path.dirname(os.path.abspath(wayverb_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        _fail(f"wayverb_tpu_torch imported from {pkg}, not from this "
              "checkout: run the script from the repository")
    # The port's reference numbers are float32; TF32 would silently round
    # any matmul/convolution to ~3 decimal digits, so both are off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} "
          "card(s); name and power limit:")
    print(smi)
    return smi


def phase_build(card):
    from concurrent.futures import ThreadPoolExecutor
    from wayverb_tpu_torch import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(lambda n: _build.build(n, force=True),
                                KERNELS))
    dt = time.perf_counter() - t0
    reports = {}
    for name, (lib, log) in zip(KERNELS, results):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        reports[name] = " | ".join(ptxas)
        print(f"[2 build] {name}.cu → {os.path.relpath(lib, ROOT)} "
              f"(nvcc, sm_90a); ptxas: {reports[name]}")
    print(f"[2 build] {len(KERNELS)} kernels built in parallel in "
          f"{dt:.2f} s [{card}]")
    return reports


def _random_step_inputs(torch, spec, x_offset, gen, rows, scale=1.0):
    """Random cur, prev, planes and halo rows of ``rows`` x rows of
    ``spec`` from global row ``x_offset``, times ``scale``."""
    from wayverb_tpu_torch.waveguide.box_fused import _plane_shapes
    _, Y, Z = spec.dims
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa
                                 device="cuda") * scale
    cur, prev = rnd(rows, Y, Z), rnd(rows, Y, Z)
    planes = tuple(rnd(*s) for s in _plane_shapes(rows, Y, Z))
    return cur, prev, planes, (rnd(1, Y, Z), rnd(1, Y, Z))


def _nan_equal(torch, a, b):
    """torch.equal, with NaN equal to NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)
                and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0)))


def phase_kernel_vs_plain(torch, hall_spec, card):
    """fused_step (CUDA kernel) against _fused_step_plain, same tensors, to
    the bit in next and the six inner planes (NaN where the plain version
    has NaN)."""
    from wayverb_tpu_torch.waveguide.box_fused import (
        BoxSpec, _fused_step_plain, fused_step)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s16 = BoxSpec(dims=(16, 16, 128), ilo=(2, 2, 2), ihi=(13, 13, 125),
                  face_surface=(0,) * 6)
    # a shard of a larger grid: local rows are global rows 4..19
    s16x = BoxSpec(dims=(20, 16, 128), ilo=(6, 2, 2), ihi=(17, 13, 125),
                   face_surface=(0,) * 6)
    s37 = BoxSpec(dims=(37, 29, 53), ilo=(2, 3, 2), ihi=(33, 25, 50),
                  face_surface=(0,) * 6)
    hx, hy, hz = hall_spec.dims
    sh = hx // SHARDS           # the sharded hall's shard, the second one
    mid = (hy // 2, hz // 2)
    # (spec, x offset, rows, source (global x, y, z), mode, input scale,
    # what it checks); the kernel's CTAs are 128 z x 2 y of one x row, its
    # warps 32 z
    cases = [
        (s16, 0, 16, (8, 9, 64), 0, 1.0, "no injection"),
        (s16, 0, 16, (8, 9, 64), 1, 1.0, "hard source deep inside"),
        (s16, 0, 16, (2, 9, 64), 2, 1.0, "soft source on the inner x plane"),
        (s16, 0, 16, (9, 4, 125), 1, 1.0, "source on the inner z plane"),
        (s16x, 4, 16, (10, 7, 40), 1, 1.0,
         "x offset 4, halos, source in shard"),
        (s37, 0, 37, (18, 14, 26), 2, 1.0, "unaligned 37x29x53"),
        (s37, 0, 37, (18, 15, 26), 1, 1.0, "source below a y tile edge"),
        (s37, 0, 37, (18, 16, 26), 2, 1.0, "source above a y tile edge"),
        (s37, 0, 37, (18, 14, 31), 1, 1.0, "source below a z tile edge"),
        (s37, 0, 37, (18, 14, 32), 2, 1.0, "source above a z tile edge"),
        (s37, 8, 16, (8, 14, 26), 1, 1.0, "source in a shard's row 0"),
        (s37, 8, 16, (23, 14, 26), 2, 1.0, "source in a shard's row X - 1"),
        (s37, 20, 2, (21, 14, 26), 1, 1.0, "a two-row shard"),
        (s37, 0, 37, (18, 14, 26), 2, 1e38, "1e38 inputs: sums overflow"),
        (hall_spec, sh, sh, (sh + sh // 2, *mid), 1, 1.0,
         "the sharded hall's shard shape, halos"),
        (hall_spec, sh, sh, (sh + sh // 2 - 1, hy // 2 + 1, hz // 2 - 1),
         2, 1.0, "source at the last y and z of a CTA"),
        (hall_spec, sh, sh, (sh + sh // 2, hy // 2 + 2, hz // 2), 1, 1.0,
         "source at the first y and z of the next CTAs"),
        (hall_spec, 0, hx, (hx // 2, *mid), 1, 1.0, "hall shape"),
    ]
    worst = 0.0
    for spec, xo, rows, src, mode, scale, what in cases:
        cur, prev, planes, halos = _random_step_inputs(torch, spec, xo, gen,
                                                       rows, scale)
        geom = spec.geom_array(x_offset=xo)
        inj_val = torch.randn(2, generator=gen, device="cuda") * scale
        args = (geom, cur, prev, planes, src + (mode,), inj_val, halos)
        got = fused_step(*args)
        want = _fused_step_plain(*args)
        torch.cuda.synchronize()
        pairs = list(zip((got[0], *got[1]), (want[0], *want[1])))
        equal = all(_nan_equal(torch, g, w) for g, w in pairs)
        finite = [torch.isfinite(w) for _, w in pairs]
        err = max(float((g - w)[f].abs().max()) if bool(f.any()) else 0.0
                  for (g, w), f in zip(pairs, finite))
        worst = max(worst, err)
        print(f"[3 B1] {tuple(cur.shape)} mode {mode} ({what}): next and "
              f"inner planes equal to the plain version's {equal}, max "
              f"|kernel - plain| = {err:.3e} where finite")
        if not equal:
            _fail(f"B1 disagrees with its plain version: {what}")
    print(f"[3 B1] {len(cases)} cases bit-equal [{card}]")
    return worst


def _t30_box():
    from wayverb_tpu_torch.core.geometry import Box
    box = Box((0, 0, 0), (2.0, 2.5, 3.0))
    d = np.asarray(box.max_corner)
    sabine = 0.161 * np.prod(d) / (
        2 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]) * ABSORPTION)
    return box, sabine, tuple(d * 0.35), tuple(d * 0.65)


def _fused_canonical(mesh, src, rcv, sim_time, env=None):
    """``canonical``'s problem run through the fused path explicitly (on the
    card ``canonical`` itself routes to the mega path)."""
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.waveguide import run as wgrun
    source, receiver, n, fs = wgrun.canonical_problem(
        mesh, src, rcv, sim_time, env or Environment())
    out = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                  receiver, n)
    intensity, pressure = out["outputs"]
    return wgrun.WaveguideOutput(pressure=pressure, intensity=intensity,
                                 sample_rate=fs, stable=out["stable"])


def _t30_of(out, sabine, tag, steps_s, card):
    from wayverb_tpu_torch.signal.filters import decay_time
    steps = out.pressure.shape[0]
    if not bool(out.stable):
        _fail(f"{tag}: T30 run unstable on the card")
    t30 = float(decay_time(out.pressure, out.sample_rate, -5, -35))
    rel = abs(t30 - sabine) / sabine
    print(f"[{tag}] {steps} steps on the card in {steps_s:.2f} s "
          f"({1e3 * steps_s / steps:.4f} ms/step): T30 {t30:.4f} s vs Sabine "
          f"{sabine:.4f} s ({100 * rel:.2f}% off, bound 5%) [{card}]")
    if not rel < 0.05:
        _fail(f"{tag}: T30 {t30} is {100 * rel:.2f}% from Sabine {sabine}")


# s of the T30 box's runs (phases 4, 8, 20): its T60 is 0.65 s, and the
# -5..-35 dB fit of its first 1.0 s equals that of 2.0 s to 1e-7 s
T30_TIME = 1.0
T30_CPU_TIME = 0.5         # s of phase 4's run repeated on the CPU


def phase_t30(torch, card):
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_cutoff_frequency, grid_spacing)
    from wayverb_tpu_torch.waveguide.postprocess import (BandpassBand,
                                                         postprocess)
    env = Environment()
    dx = grid_spacing(env.speed_of_sound, 1.0 / FS)
    box, sabine, src, rcv = _t30_box()
    absorption = np.full((1, 8), ABSORPTION)

    mesh = wgrun.shoebox_mesh(box, absorption, dx, FS, device="cuda")
    print(f"[4 t30] {mesh.descriptor.dimensions} grid, fused path (first "
          "run on the card)")
    t0 = time.perf_counter()
    out = _fused_canonical(mesh, src, rcv, T30_TIME, env)
    torch.cuda.synchronize()
    _t30_of(out, sabine, "4 t30", time.perf_counter() - t0, card)
    steps = out.pressure.shape[0]

    # the CPU's run of the first T30_CPU_TIME s: a prefix of the card's
    mesh_cpu = wgrun.shoebox_mesh(box, absorption, dx, FS, device="cpu")
    t0 = time.perf_counter()
    out_cpu = wgrun.canonical(mesh_cpu, src, rcv, T30_CPU_TIME, env)
    t_cpu = time.perf_counter() - t0
    p_gpu = out.pressure.cpu()[:out_cpu.pressure.shape[0]]
    peak = float(out_cpu.pressure.abs().max())
    err = float((p_gpu - out_cpu.pressure).abs().max())
    print(f"[4 t30] card vs plain CPU run, the first "
          f"{out_cpu.pressure.shape[0]} steps: max |Δp| = {err:.3e}, bound "
          f"1e-4 × peak {peak:.4f} = {1e-4 * peak:.3e} (CPU run "
          f"{t_cpu:.2f} s)")
    if not (err <= 1e-4 * peak and bool(out_cpu.stable)):
        _fail(f"card and CPU pressure differ by {err} (peak {peak})")

    band = BandpassBand(pressure=out.pressure, intensity=out.intensity,
                        sample_rate=out.sample_rate,
                        valid_hz=(0.0, compute_cutoff_frequency(FS, 0.6)))
    audio = postprocess([band], Null(), env.acoustic_impedance, 44100.0)
    want_len = int(steps * (44100.0 / out.sample_rate))
    finite = bool(torch.isfinite(audio).all())
    print(f"[4 t30] postprocess (Null) to 44.1 kHz: {tuple(audio.shape)} "
          f"samples (expected {want_len}), finite {finite}")
    if audio.shape != (want_len,) or not finite:
        _fail("postprocess output has the wrong length or is not finite")
    return mesh, out, sabine, src, rcv


def _hall_box(dx):
    from wayverb_tpu_torch.core.geometry import Box
    side = (224, 224, 256)     # bench.py's production-scale shoebox
    return Box((0, 0, 0), tuple(dx * (s - 4) for s in side))


def _hall_mesh(torch):
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    box = _hall_box(dx)
    t0 = time.perf_counter()
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), ABSORPTION), dx, FS,
                              device="cuda")
    return box, dx, mesh, time.perf_counter() - t0


def _hall_positions(box, dx):
    """Source at the hall's centre, receiver 4 nodes off it in z."""
    centre = np.asarray(box.centre())
    return tuple(centre), tuple(centre + np.asarray([0.0, 0.0, 4 * dx]))


def _cuda_time_us(torch, fn, reps):
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


def _hall_sim_time(mesh, steps):
    fs = mesh.descriptor.sample_rate(340.0)
    sim_time = (steps - 0.5) / fs
    if math.ceil(fs * sim_time) != steps:
        _fail(f"hall simulation time does not give {steps} steps")
    return sim_time


def phase_hall(torch, box, dx, mesh, setup_s, card):
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    steps = 1024
    desc = mesh.descriptor
    nodes = desc.num_nodes
    sim_time = _hall_sim_time(mesh, steps)
    src, rcv = _hall_positions(box, dx)
    print(f"[5 hall] {desc.dimensions} = {nodes} nodes, mesh setup "
          f"{setup_s:.2f} s on the host; fused path (run_waveguide_box)")

    _fused_canonical(mesh, src, rcv, 16 / desc.sample_rate(340.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_step.launches = 0
    t0 = time.perf_counter()
    out = _fused_canonical(mesh, src, rcv, sim_time)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_step.launches
    peak_mem = torch.cuda.max_memory_allocated()
    n = out.pressure.shape[0]
    finite = bool(torch.isfinite(out.pressure).all()
                  and torch.isfinite(out.intensity).all())
    stable = bool(out.stable)
    print(f"[5 hall] {n} steps: stable {stable}, finite {finite}, "
          f"fused_step launches {launches}, peak |p| "
          f"{float(out.pressure.abs().max()):.4f}")
    if not (n == steps and stable and finite and launches == steps):
        _fail("hall run failed its checks")
    print(f"[5 hall] fused wall {1e3 * wall / steps:.4f} ms/step, "
          f"{nodes * steps / wall:.4e} node-updates/s, peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    return out, launches, wall / steps


def phase_kernel_time(torch, spec, card):
    """B1 alone at the hall shape and at the sharded hall's shard shape
    with halos, with the stream held (``mega_timing.b1_shape``: bit-equal
    to the plain version, device and host µs, bound, occupancy), and the
    plain version's time at the hall."""
    from wayverb_tpu_torch.tools.mega_timing import b1_shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    X = spec.dims[0]
    rows = {"hall": b1_shape(spec, 0, X, gen, False, plain_reps=20),
            "shard": b1_shape(spec, X // SHARDS, X // SHARDS, gen, True)}
    for name, r in rows.items():
        occ = r["occupancy"]
        print(f"[5 hall] B1 alone at the {name} shape {tuple(r['shape'])}"
              f"{' with halos' if r['halos'] else ''}: {r['us_per_step']:.2f}"
              f" us/step on the card (stream held), the wrapper's host "
              f"{r['host_us_per_call']:.1f} us a call; bound "
              f"{r['bound_us']:.2f} us ({r['bound_by']}), "
              f"{r['time_over_bound']:.2f}x; bit-equal {r['equal_plain']}; "
              f"{occ['registers']} registers, {occ['local_bytes']} B local, "
              f"{occ['ctas_per_sm']} CTAs of {occ['threads']} an SM, "
              f"{occ['grid']} CTAs a step"
              + (f"; plain version {r['plain_us_per_step']:.2f} us/step"
                 if "plain_us_per_step" in r else "") + f" [{card}]")
        if not r["equal_plain"]:
            _fail(f"B1 disagrees with its plain version at the {name} "
                  "shape")
    return rows


def _profile_window(torch, tag, run, steps, step_s, card):
    """Profile ``run()`` (``steps`` steps) and print where a step's time
    goes.  ``step_s``: the unprofiled wall time per step of the long run;
    the profiler's own overhead inflates the profiled wall time.  Returns
    (device busy us/step, device kernels/step, idle share of the unprofiled
    step, {kernel name: us/step}, {kernel name: launches in the window}), or
    None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((t, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    if busy_us <= 0:
        print(f"[{tag}] device time not measured: the profiler saw no "
              f"device activity (wall {wall_us / steps:.1f} us/step)")
        return None
    busy_step_us = busy_us / steps
    idle = 1 - busy_step_us / (1e6 * step_s)
    print(f"[{tag}] {steps} profiled steps: wall {wall_us / steps:.1f} "
          f"us/step (profiler on), device busy {busy_step_us:.1f} us/step, "
          f"{n_kernels / steps:.1f} device kernels/step; idle share "
          f"{1 - busy_us / wall_us:.3f} of the profiled wall, "
          f"{idle:.3f} of the unprofiled "
          f"{1e6 * step_s:.1f} us/step [{card}]")
    for t, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[{tag}]   {t / steps:9.2f} us/step  {count / steps:6.2f}"
              f"/step  {key[:90]}")
    return (busy_step_us, n_kernels / steps, idle,
            {key: t / steps for t, _, key in rows},
            {key: count for _, count, key in rows})


def phase_profile(torch, mesh, box, dx, step_s, card):
    """Where a fused step's time goes: a profiled 32-step window."""
    steps = 32
    fs = mesh.descriptor.sample_rate(340.0)
    src, rcv = _hall_positions(box, dx)
    return _profile_window(
        torch, "5 profile",
        lambda: _fused_canonical(mesh, src, rcv, (steps - 0.5) / fs), steps,
        step_s, card)


# ---------------------------------------------------------------------------
# B2, the mega chunk

def _random_chunk_inputs(torch, spec, order, gen):
    """Random fields, state and planes, zero in the planes' padding."""
    from wayverb_tpu_torch.waveguide.box_fused import stacked_plane_shape
    Umax, Vmax = stacked_plane_shape(spec)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    mask = torch.zeros((6, Umax, Vmax), device="cuda")
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    st = rnd(order, 6, Umax, Vmax) * mask
    pln = rnd(3, 6, Umax, Vmax) * mask
    return rnd(*spec.dims), rnd(*spec.dims), st.contiguous(), \
        pln.contiguous()


def _chunk_case(torch, spec, fb, fa, src, taps, gen, scale=1.0):
    """B2 and its plain version on the same inputs: (max |Δ|, peak, bad
    kernel, bad plain, kernel outputs)."""
    from wayverb_tpu_torch.waveguide.box_mega import (_mega_chunk_plain,
                                                      mega_chunk)
    order = fb.shape[1] - 1
    cur, prev, st, pln = (t * scale for t in _random_chunk_inputs(
        torch, spec, order, gen))
    sig = torch.randn(CHUNK, generator=gen, device="cuda")
    args = (spec, sig, fb, fa)
    state = (cur, prev, st, pln)
    want = _mega_chunk_plain(*args, *state, src, taps)
    got = mega_chunk(*args, *(t.clone() for t in state), src, taps)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got[:5], want[:5]))
    peak = max(float(w.abs().max()) for w in want[:5])
    return err, peak, float(got[5]), float(want[5]), got


def _report_chunk(tag, what, err, peak, bad_k, bad_p):
    """Print one B2-vs-plain case and fail unless the two agree to the bit;
    returns err."""
    print(f"[{tag}] {what}: max |kernel - plain| = {err:.3e} over taps, "
          f"fields, state and planes, peak {peak:.3e} (bound 0: bit-equal); "
          f"bad count kernel {bad_k:g}, plain {bad_p:g}")
    if not (err == 0.0 and bad_k == bad_p):
        _fail(f"B2 disagrees with its plain version: {what}")
    return err


def _hall_chunk_problem(torch, mesh, box, dx):
    """The hall run's source (x, y, z, mode) and receiver tap nodes."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    src_pos, rcv_pos = _hall_positions(box, dx)
    source, receiver, _, _ = wgrun.canonical_problem(mesh, src_pos, rcv_pos,
                                                     CHUNK / FS)
    src = tuple(int(v) for v in
                source.kernel_injection(mesh.box_spec.dims, 0)[0])
    return src, receiver.tap_nodes().reshape(-1).to(torch.int64).contiguous()


def phase_mega_vs_plain(torch, hall_mesh, box, dx, card):
    """B2 against _mega_chunk_plain, K = 128, at three shapes; returns the
    worst max |Δ| and the hall case for timing."""
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import (BoxSpec,
                                                       face_coefficients)
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0

    def report(what, err, peak, bad_k, bad_p):
        nonlocal worst
        worst = max(worst, _report_chunk("6 B2", what, err, peak, bad_k,
                                         bad_p))

    # 1. a small unaligned box, the source on each inner plane in turn
    small = BoxSpec(dims=(21, 17, 26), ilo=(2, 3, 2), ihi=(18, 13, 23),
                    face_surface=(0,) * 6)
    t30_mesh = wgrun.shoebox_mesh(*_t30_box()[:1], np.full((1, 8),
                                                           ABSORPTION),
                                  grid_spacing(340.0, 1.0 / FS), FS,
                                  device="cuda")
    fb, fa = face_coefficients(t30_mesh.structure, t30_mesh.box_spec)
    mid = [(small.ilo[a] + small.ihi[a]) // 2 for a in range(3)]
    for p in range(6):
        a, side = divmod(p, 2)
        loc = list(mid)
        loc[a] = small.ilo[a] if side == 0 else small.ihi[a]
        X, Y, Z = small.dims
        flat = (loc[0] * Y + loc[1]) * Z + loc[2]
        taps = torch.tensor([flat, flat + 1, flat - Z, 5, X * Y * Z - 1],
                            device="cuda")
        err, peak, bk, bp, _ = _chunk_case(
            torch, small, fb, fa, tuple(loc) + (1 + p % 2,), taps, gen)
        report(f"{small.dims} source on inner plane {p} "
               f"({'hard' if p % 2 == 0 else 'soft'})", err, peak, bk, bp)

    # 2. the T30 box with a soft source and its receiver's taps
    spec = t30_mesh.box_spec
    box, _, src_pos, rcv_pos = _t30_box()
    source, receiver, _, _ = wgrun.canonical_problem(
        t30_mesh, src_pos, rcv_pos, 0.1, Environment())
    src = source.kernel_injection(spec.dims, 0)[0][:3] + (2,)
    err, peak, bk, bp, _ = _chunk_case(torch, spec, fb, fa, src,
                                       receiver.tap_nodes(), gen)
    report(f"T30 box {spec.dims}, soft source", err, peak, bk, bp)

    # 3. the hall, from random field, state and planes, with the hall
    # run's hard source and its receiver's taps
    spec = hall_mesh.box_spec
    fb, fa = face_coefficients(hall_mesh.structure, spec)
    src, taps = _hall_chunk_problem(torch, hall_mesh, box, dx)
    err, peak, bk, bp, _ = _chunk_case(torch, spec, fb, fa, src, taps, gen)
    report(f"hall {spec.dims}, random state, hall source and taps", err,
           peak, bk, bp)
    return worst, (spec, fb, fa, src, taps)


def phase_mega_time(torch, case, ptxas, card):
    """B2 alone at the hall shape, and its plain version (CUDA events); what
    the card makes of the kernel; one chunk under the profiler.  Returns
    (kernel µs, plain µs, occupancy)."""
    from wayverb_tpu_torch.tools.mega_timing import profile_chunk
    from wayverb_tpu_torch.waveguide.box_mega import (_mega_chunk_plain,
                                                      chunk_occupancy,
                                                      mega_chunk)
    spec, fb, fa, src, taps = case
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    state = _random_chunk_inputs(torch, spec, fb.shape[1] - 1, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda") * 1e-3
    k_us = _cuda_time_us(torch, lambda: mega_chunk(
        spec, sig, fb, fa, *state, src, taps), 5)
    p_us = _cuda_time_us(torch, lambda: _mega_chunk_plain(
        spec, sig, fb, fa, *state, src, taps), 1)
    occ = chunk_occupancy()
    print(f"[7 mega] B2 alone at {spec.dims}: kernel {k_us / CHUNK:.2f} "
          f"us/sub-step ({k_us / 1e3:.3f} ms per K = {CHUNK} chunk), plain "
          f"version {p_us / CHUNK:.2f} us/sub-step; {occ['registers']} "
          f"registers, {occ['local_bytes']} B local, {occ['ctas_per_sm']} "
          f"CTAs an SM, a cooperative grid of {occ['grid']} CTAs; ptxas: "
          f"{ptxas.get('box_mega_chunk', '')} [{card}]")
    prof = profile_chunk(case, gen)
    print(f"[7 mega] one profiled chunk: {prof['chunk_launches']} launch(es) "
          f"of the chunk kernel; every kernel {prof['kernels']}, span "
          f"{prof['span_us']:.1f} us, gaps {prof['gaps_us']} us [{card}]")
    if prof["gaps_us"] is not None and prof["chunk_launches"] != 1:
        _fail(f"a B2 chunk launched {prof['chunk_launches']} kernels, not "
              "one")
    return k_us, p_us, occ


def phase_mega_hall(torch, box, dx, mesh, fused_out, fused_step_s, card):
    """canonical (the mega path on the card) against the fused path."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    steps = 1024
    nodes = mesh.descriptor.num_nodes
    sim_time = _hall_sim_time(mesh, steps)
    src, rcv = _hall_positions(box, dx)
    wgrun.canonical(mesh, src, rcv, (CHUNK - 0.5) / FS)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_step.launches = 0
    mega_chunk.launches = 0
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, src, rcv, sim_time)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    m_launch, f_launch = mega_chunk.launches, fused_step.launches
    peak = float(fused_out.pressure.abs().max())
    err_p = float((out.pressure - fused_out.pressure).abs().max())
    err_i = float((out.intensity - fused_out.intensity).abs().max())
    ipeak = float(fused_out.intensity.abs().max())
    rel = max(err_p / peak, err_i / max(ipeak, 1e-30))
    print(f"[7 mega] hall {steps} steps through canonical: stable "
          f"{bool(out.stable)}, mega_chunk launches {m_launch} (expected "
          f"{-(-steps // CHUNK)}), fused_step launches {f_launch} (expected "
          "0)")
    print(f"[7 mega] mega vs fused: max |Δp| {err_p:.3e} on peak {peak:.4f},"
          f" max |Δintensity| {err_i:.3e} on peak {ipeak:.3e}: {rel:.3e} of "
          f"peak (bound {MEGA_VS_FUSED_REL:g})")
    print(f"[7 mega] mega wall {1e3 * wall / steps:.4f} ms/step, "
          f"{nodes * steps / wall:.4e} node-updates/s, peak memory "
          f"{peak_mem / 2**20:.1f} MiB; fused wall {1e3 * fused_step_s:.4f} "
          f"ms/step, {nodes / fused_step_s:.4e} node-updates/s [{card}]")
    if not (bool(out.stable) and m_launch == -(-steps // CHUNK)
            and f_launch == 0 and rel <= MEGA_VS_FUSED_REL):
        _fail("mega hall run failed its checks")
    return rel


def phase_t30_mega(torch, mesh, fused_out, sabine, src, rcv, card):
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    mega_chunk.launches = 0
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, src, rcv, T30_TIME, Environment())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if mega_chunk.launches == 0:
        _fail("T30 through canonical did not take the mega path")
    _t30_of(out, sabine, "8 t30 mega", dt, card)
    peak = float(fused_out.pressure.abs().max())
    err = float((out.pressure - fused_out.pressure).abs().max())
    print(f"[8 t30 mega] {mega_chunk.launches} chunks; mega vs fused on the "
          f"card: max |Δp| {err:.3e}, {err / peak:.3e} of peak")


# ---------------------------------------------------------------------------
# the hybrid engine

def _engine(torch, box, cutoff, device, absorption=ABSORPTION,
            scattering=0.1, bands=1):
    """A shoebox engine; ``absorption`` is one value or one per band."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.geometry import box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    surfaces = Surface(
        absorption=torch.broadcast_to(torch.tensor(absorption), (1, 8)),
        scattering=torch.full((1, 8), scattering))
    return eng.Engine(box_scene(box), surfaces,
                      eng.WaveguideParameters(cutoff=cutoff,
                                              usable_portion=0.6,
                                              bands=bands),
                      scene_box=box, device=device)


class _RunMarks:
    """``Engine.run``'s state callback: the seconds of each phase (each
    ended by a synchronise), the peak device memory of the whole run, and
    the waveguide leg's own peak above what was allocated when it began
    (the ray leg's memory grows with the bounces it traces)."""

    def __init__(self, torch):
        self.cuda, self.marks, self.mem = torch.cuda, [], {}
        self.cuda.reset_peak_memory_stats()

    def __call__(self, name):
        self.cuda.synchronize()
        self.marks.append((name, time.perf_counter()))
        if name == "running_waveguide":
            self.mem["before_waveguide"] = self.cuda.max_memory_allocated()
            self.mem["waveguide_base"] = self.cuda.memory_allocated()
            self.cuda.reset_peak_memory_stats()
        elif name == "finishing":
            self.mem["waveguide"] = self.cuda.max_memory_allocated() \
                - self.mem["waveguide_base"]

    def seconds(self):
        return {self.marks[i][0]: self.marks[i + 1][1] - self.marks[i][1]
                for i in range(len(self.marks) - 1)}

    def peaks(self):
        """(whole run, waveguide leg) peak bytes; call after the run."""
        return (max(self.mem["before_waveguide"],
                    self.cuda.max_memory_allocated()), self.mem["waveguide"])


def phase_hybrid_hall(torch, hall_spec, card):
    """Engine.run + render on the hybrid hall; seconds of each phase.  Then
    B2 against its plain version on the engine's mesh, filter coefficients,
    source and receiver taps.  Returns the launch counts, the engine mesh's
    dims and B2's max |Δ| there."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Microphone, Null
    from wayverb_tpu_torch.waveguide.box_fused import (face_coefficients,
                                                       fused_step)
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    box = _hall_box(dx)
    src, rcv = _hall_positions(box, dx)
    t0 = time.perf_counter()
    e = _engine(torch, box, 500.0, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    params = eng.RaytracerParameters()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    mega_chunk.launches = 0
    fused_step.launches = 0
    mark = _RunMarks(torch)
    mark("start")
    results = e.run(src, rcv, gen, params, waveguide_time=0.3,
                    state_callback=mark)
    mark("end")
    launches = {"box_mega_chunk": mega_chunk.launches,
                "box_fused_step": fused_step.launches}
    t_render = time.perf_counter()
    ir = eng.render(results, Null(), 44100.0, gen)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t_render
    both = eng.render_all(results, [Null(), Microphone(shape=0.5)], gen,
                          output_sample_rate=44100.0)
    torch.cuda.synchronize()
    secs = mark.seconds()
    trace_s = secs["running_raytracer"]
    depth = eng.optimum_depth(e.surfaces)
    print(f"[9 hybrid] hall {box.max_corner} m, mesh "
          f"{e.mesh.descriptor.dimensions}, engine setup {setup:.2f} s; "
          f"{params.rays} rays x {depth} bounces")
    print(f"[9 hybrid] seconds: trace {trace_s:.3f}, image sources "
          f"{secs['finding_image_sources']:.3f}, waveguide "
          f"{secs['running_waveguide']:.3f} "
          f"({results.waveguide_bands[0].pressure.shape[0]} steps), finish "
          f"{secs['finishing']:.3f}, render {t_render:.3f}; trace "
          f"{params.rays * depth / trace_s:.4e} ray-bounces/s; launches "
          f"{launches} [{card}]")
    ir_np = ir.cpu().numpy()
    finite = bool(np.all(np.isfinite(ir_np))) and \
        bool(torch.isfinite(both).all())
    d = float(np.linalg.norm(np.subtract(src, rcv)))
    arrival = d / 340.0
    peak_t = float(np.abs(ir_np).argmax()) / 44100.0
    half = int(0.5 * 44100)
    early = float(np.square(ir_np[:half]).sum())
    late = float(np.square(ir_np[-half:]).sum())
    print(f"[9 hybrid] IR {ir_np.shape[0]} samples at 44.1 kHz, finite "
          f"{finite}; peak at {1e3 * peak_t:.2f} ms, direct arrival "
          f"{1e3 * arrival:.2f} ms (bound 20 ms); energy first 0.5 s "
          f"{early:.4e}, last 0.5 s {late:.4e}; render_all "
          f"{tuple(both.shape)}, max {float(both.abs().max()):.4f}")
    if not (finite and abs(peak_t - arrival) <= 0.02 and late < early
            and launches["box_mega_chunk"] > 0
            and tuple(both.shape) == (2, ir_np.shape[0])):
        _fail("hybrid hall failed its checks")

    spec = e.mesh.box_spec
    if spec != hall_spec:
        _fail(f"the engine's hall mesh {spec} is not the mesh phases 5-7 "
              f"checked, {hall_spec}")
    fb, fa = face_coefficients(e.mesh.structure, spec)
    src, taps = _hall_chunk_problem(torch, e.mesh, box, dx)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    err, peak, bk, bp, _ = _chunk_case(torch, spec, fb, fa, src, taps, gen)
    _report_chunk("9 B2", f"engine hall {spec.dims}, engine filters, source "
                  f"{src} and {taps.numel()} receiver taps, random state",
                  err, peak, bk, bp)
    return launches, spec.dims, err


def phase_hybrid_card_vs_cpu(torch, card):
    """The test_combined.py box on the card and on the CPU, same draws."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    box = Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    params = eng.RaytracerParameters(rays=1 << 13, max_time=1.5)
    irs, secs = [], []
    for device in ("cuda", "cpu"):
        mega_chunk.launches = 0
        t0 = time.perf_counter()
        e = _engine(torch, box, 400.0, device)
        # CPU generators: both runs draw the same numbers
        results = e.run(src, rcv, torch.Generator().manual_seed(SEED), params,
                        waveguide_time=0.25)
        ir = eng.render(results, Null(), 16000.0,
                        torch.Generator().manual_seed(SEED + 1))
        irs.append(ir.cpu())
        secs.append(time.perf_counter() - t0)
        if (mega_chunk.launches > 0) != (device == "cuda"):
            _fail(f"hybrid on {device}: unexpected waveguide route")
    card_ir, cpu_ir = irs
    peak = float(cpu_ir.abs().max())
    err = float((card_ir - cpu_ir).abs().max()) \
        if card_ir.shape == cpu_ir.shape else float("inf")
    print(f"[10 hybrid] test_combined box, {params.rays} rays: card "
          f"{secs[0]:.2f} s (mega path), CPU {secs[1]:.2f} s (fused path); "
          f"IR {tuple(card_ir.shape)} vs {tuple(cpu_ir.shape)}, max |Δ| "
          f"{err:.3e} = {err / peak:.3e} of peak (bound {HYBRID_REL:g}) "
          f"[{card}]")
    if not err <= HYBRID_REL * peak:
        _fail("hybrid IR on the card differs from the CPU run")
    return err / peak


# ---------------------------------------------------------------------------
# every capsule, every band: the multiband waveguide and the Hrtf capsule

# per-band absorption of the multiband hall; 4 bands are the hrtf bands
# below the 500 Hz cutoff (edges 20, 47, 112, 267 Hz; the fifth starts at
# 632 Hz)
MULTIBAND_ABSORPTION = (0.4, 0.2, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05)
MULTIBAND_BANDS = 4
MULTIBAND_MEMORY = 1.1     # multiband peak memory over the single band's
HRTF_DIRECTIONS = 1 << 16


def phase_multiband_hall(torch, card):
    """Phase 9's hybrid hall with ``WaveguideParameters(bands=4)`` and
    per-band absorption: ``Engine.run`` (one ``canonical`` a band, each on
    B2), then ``render_all`` with both ears of ``Hrtf``.  Checks every
    band finite and stable, contiguous band ranges, the late energy of a
    band falling as its absorption rises, 4 x 8 B2 launches, the four
    capsules' IRs, and the peak memory, of the whole run and of the
    waveguide leg above its start, within 1.1x a single band's run at the
    same absorption (made first, so that its ray leg traces the same
    bounces): the bands do not hold one another's fields."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    from wayverb_tpu_torch.waveguide.box_mega import DEFAULT_CHUNK, mega_chunk
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    box = _hall_box(dx)
    src, rcv = _hall_positions(box, dx)
    params = eng.RaytracerParameters()
    control = _engine(torch, box, 500.0, "cuda",
                      absorption=MULTIBAND_ABSORPTION)
    mark = _RunMarks(torch)
    control.run(src, rcv, torch.Generator(device="cuda").manual_seed(SEED + 4),
                params, waveguide_time=0.3, state_callback=mark)
    single_peak = mark.peaks()
    del control
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    e = _engine(torch, box, 500.0, "cuda", absorption=MULTIBAND_ABSORPTION,
                bands=MULTIBAND_BANDS)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    band_s = []

    # each band's waveguide seconds: the engine's multiband leg calls
    # run.canonical once a band
    canonical = wgrun.canonical

    def timed_canonical(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = canonical(*args, **kwargs)
        torch.cuda.synchronize()
        band_s.append(time.perf_counter() - t)
        return out

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    wgrun.canonical = timed_canonical
    try:
        mega_chunk.launches = 0
        fused_step.launches = 0
        mark = _RunMarks(torch)
        mark("start")
        results = e.run(src, rcv, gen, params, waveguide_time=0.3,
                        state_callback=mark)
        mark("end")
        launches = {"box_mega_chunk": mega_chunk.launches,
                    "box_fused_step": fused_step.launches}
    finally:
        wgrun.canonical = canonical
    peak_mem = mark.peaks()
    secs = mark.seconds()
    bands = results.waveguide_bands
    steps = bands[0].pressure.shape[0]
    expect = MULTIBAND_BANDS * -(-steps // DEFAULT_CHUNK)
    print(f"[36 multiband hall] hall {box.max_corner} m, mesh "
          f"{e.mesh.descriptor.dimensions}, {MULTIBAND_BANDS} bands, "
          f"absorption {MULTIBAND_ABSORPTION}, engine setup {setup:.2f} s; "
          f"{params.rays} rays x {eng.optimum_depth(e.surfaces)} bounces; "
          f"seconds: trace {secs['running_raytracer']:.3f}, image sources "
          f"{secs['finding_image_sources']:.3f}, waveguide "
          f"{secs['running_waveguide']:.3f} ({steps} steps a band), finish "
          f"{secs['finishing']:.3f} [{card}]")
    print(f"[36 multiband hall] waveguide seconds a band "
          f"{[round(t, 4) for t in band_s]}; launches {launches} (expected "
          f"{expect} B2, none of B1); peak memory of the run "
          f"{peak_mem[0] / 2**20:.1f} MiB against one band's at the same "
          f"absorption {single_peak[0] / 2**20:.1f}: "
          f"{peak_mem[0] / single_peak[0]:.4f}x, of the waveguide leg above "
          f"its start {peak_mem[1] / 2**20:.1f} MiB against one band's "
          f"{single_peak[1] / 2**20:.1f}: {peak_mem[1] / single_peak[1]:.4f}x "
          f"(bound {MULTIBAND_MEMORY} on both) [{card}]")

    late = []
    for b in bands:
        p = b.pressure.float()
        late.append(float(torch.sum(p[steps // 2:] ** 2)))
        finite = bool(torch.isfinite(p).all()) and \
            bool(torch.isfinite(b.intensity).all())
        if not (finite and bool(b.stable)):
            _fail(f"multiband hall: band {b.valid_hz} not finite or not "
                  "stable")
    ranges = [b.valid_hz for b in bands]
    contiguous = ranges[0][0] == 20.0 and all(
        lo[1] == hi[0] for lo, hi in zip(ranges, ranges[1:]))
    # the bands in the order of rising absorption: late energy must fall
    order = sorted(range(len(bands)), key=lambda b: MULTIBAND_ABSORPTION[b])
    falls = all(late[a] > late[b] for a, b in zip(order, order[1:]))
    print(f"[36 multiband hall] bands "
          f"{[(round(lo, 2), round(hi, 2)) for lo, hi in ranges]} Hz, "
          f"contiguous {contiguous}; late energy (sum p^2 over the second "
          f"half) {[f'{x:.4e}' for x in late]}: falls as absorption rises "
          f"{falls} [{card}]")

    t_render = time.perf_counter()
    capsules = [Null(), Microphone(shape=0.5), Hrtf(channel=0),
                Hrtf(channel=1)]
    irs = eng.render_all(results, capsules, gen, output_sample_rate=44100.0)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t_render
    ears = float((irs[2] - irs[3]).abs().max())
    peak = float(irs.abs().max())
    finite = bool(torch.isfinite(irs).all())
    print(f"[36 multiband hall] render_all(Null, Microphone(0.5), Hrtf(0), "
          f"Hrtf(1)) {t_render:.3f} s: {tuple(irs.shape)}, finite {finite}, "
          f"max |.| {peak!r}, max |left - right| {ears:.4e} [{card}]")
    if not (contiguous and falls and launches["box_mega_chunk"] == expect
            and launches["box_fused_step"] == 0
            and peak_mem[0] <= MULTIBAND_MEMORY * single_peak[0]
            and peak_mem[1] <= MULTIBAND_MEMORY * single_peak[1]
            and irs.shape[0] == 4 and irs.dim() == 2 and finite
            and peak == 1.0 and ears > 0.0):
        _fail("the multiband hall failed its checks")
    result = {"setup_s": setup, "seconds": secs, "band_waveguide_s": band_s,
              "steps": steps, "launches": launches,
              "peak_memory_bytes": peak_mem[0],
              "waveguide_peak_memory_bytes": peak_mem[1],
              "single_band_peak_memory_bytes": single_peak[0],
              "single_band_waveguide_peak_memory_bytes": single_peak[1],
              "late_energy": late, "render_all_s": t_render,
              "ears_max_abs_diff": ears}
    print(json.dumps({"phase": "36 multiband hall", **result}))
    return result


def _multiband_card_vs_cpu(torch, absorption, card):
    """The test_combined box with ``bands=2`` at ``absorption`` on the card
    and on the CPU, same CPU generators: each band's pressure, and the IR
    rendered with ``Hrtf(channel=0)`` and with ``Null``, card against CPU
    as a share of the CPU's peak, with the image-source head and the
    stochastic tail of the ``Null`` IR apart (each of its own peak)."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Hrtf, Null
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.imagesource.postprocess import \
        postprocess as is_postprocess
    from wayverb_tpu_torch.raytracer import stochastic
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    box = Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    params = eng.RaytracerParameters(rays=1 << 13, max_time=1.5)
    runs, secs = [], []
    for device in ("cuda", "cpu"):
        mega_chunk.launches = 0
        t0 = time.perf_counter()
        e = _engine(torch, box, 400.0, device, absorption=absorption,
                    bands=2)
        r = e.run(src, rcv, torch.Generator().manual_seed(SEED), params,
                  waveguide_time=0.25)
        env = r.environment
        out = {"bands": [b.pressure.cpu() for b in r.waveguide_bands]}
        for name, method in (("hrtf", Hrtf(channel=0)), ("null", Null())):
            out[name] = eng.render(r, method, 16000.0, torch.Generator()
                                   .manual_seed(SEED + 1)).cpu()
        out["head"] = is_postprocess(r.image_source, Null(), r.receiver,
                                     env.speed_of_sound, 16000.0).cpu()
        out["tail"] = stochastic.postprocess(
            r.stochastic_histogram, r.histogram_sample_rate, Null(),
            r.room_volume, env, 16000.0,
            torch.Generator().manual_seed(SEED + 1)).cpu()
        runs.append(out)
        secs.append(time.perf_counter() - t0)
        if (mega_chunk.launches > 0) != (device == "cuda"):
            _fail(f"multiband hybrid on {device}: unexpected waveguide "
                  "route")
    got, want = runs

    def rel(c, p, peak=None):
        if c.shape != p.shape:
            return float("inf")
        peak = float(p.abs().max()) if peak is None else peak
        return float((c - p).abs().max()) / peak

    peak = float(want["null"].abs().max())
    errs = {"bands": [rel(c, p) for c, p in zip(got["bands"],
                                                  want["bands"])],
            "hrtf_ir": rel(got["hrtf"], want["hrtf"]),
            "null_ir": rel(got["null"], want["null"], peak),
            "head": rel(got["head"], want["head"]),
            "tail": rel(got["tail"], want["tail"]),
            "card_s": secs[0], "cpu_s": secs[1]}
    print(f"[37 multiband card vs cpu] test_combined box, bands=2, "
          f"absorption {absorption}, {params.rays} rays: card {secs[0]:.2f} s "
          f"(mega path), CPU {secs[1]:.2f} s (fused path); band pressure "
          f"max |d| / peak {[f'{x:.3e}' for x in errs['bands']]}; IR max "
          f"|d| / peak: Hrtf(0) {errs['hrtf_ir']:.3e}, Null "
          f"{errs['null_ir']:.3e}; of the Null IR, the image-source head "
          f"{errs['head']:.3e} and the stochastic tail {errs['tail']:.3e} "
          f"of their own peaks [{card}]")
    return errs


TAIL_AGREE = 0.999         # rays whose triangle history agrees, card vs CPU
TAIL_KEPT_L1 = 1e-5        # agreeing rays: histogram L1 card vs CPU, of total
TAIL_KEPT_REL = 1e-4       # agreeing rays: their tail card vs CPU, of peak
TAIL_DEPTH_CUT = 2         # the split traces half the engine's bounces


def _ray_ops_card_vs_cpu(torch, card):
    """The ray leg's three-vector reductions on 2^20 random vectors, card
    against CPU: the share of results whose bits differ for the library
    ops (a last-axis ``sum``, ``vector_norm``, a float32 ``mean`` of 8,
    ``sqrt``, each device's ``sqrt`` against the correctly rounded one)
    and for ``core.geometry``'s ``dot3``, ``norm3`` and ``sqrt32``, which
    must agree on all."""
    from wayverb_tpu_torch.core.geometry import dot3, norm3, sqrt32
    gen = torch.Generator().manual_seed(SEED + 37)
    a = torch.randn(1 << 20, 3, generator=gen)
    b = torch.randn(1 << 20, 3, generator=gen)
    eight = torch.cat([a, b, a[:, :2]], dim=-1)
    ops = {"sum(a * b, -1)": lambda x, y, e: torch.sum(x * y, dim=-1),
           "vector_norm": lambda x, y, e: torch.linalg.vector_norm(x, dim=-1),
           "linalg.cross": lambda x, y, e: torch.linalg.cross(x, y, dim=-1),
           "mean of 8": lambda x, y, e: e.mean(dim=-1),
           "sqrt": lambda x, y, e: torch.sqrt(x.abs()),
           "x / y": lambda x, y, e: x / y,
           "dot3": lambda x, y, e: dot3(x, y),
           "norm3": lambda x, y, e: norm3(x),
           "sqrt32": lambda x, y, e: sqrt32(x.abs())}
    differ = {}
    for name, f in ops.items():
        on_card = f(a.cuda(), b.cuda(), eight.cuda()).cpu()
        differ[name] = float((on_card != f(a, b, eight)).float().mean())
    exact = torch.from_numpy(np.sqrt(a.abs().numpy()))
    differ["sqrt on the card vs correctly rounded"] = float(
        (torch.sqrt(a.abs().cuda()).cpu() != exact).float().mean())
    differ["sqrt on the CPU vs correctly rounded"] = float(
        (torch.sqrt(a.abs()) != exact).float().mean())
    print(f"[37 ray ops] share of 2^20 random results whose bits differ, "
          f"card vs CPU: {json.dumps(differ)} [{card}]")
    if any(differ[k] for k in ("dot3", "norm3", "sqrt32")):
        _fail("the ray leg's three-vector ops differ between card and CPU")
    return differ


def _tail_split(torch, card):
    """The two traces behind the low-absorption tail of phase 37, card
    against CPU with the same directions (the engine's trace: ``trace_jit``
    at the engine's depth and rays): the histograms bin by bin, the share
    of rays whose triangle history agrees at every bounce, and both
    histograms traced again from those rays alone, with their tails; for
    the others, the bounce at which each first parts and whether the two
    triangles hit there are coplanar (one wall's two halves) or on two
    walls (a box edge or corner); the reflection points
    (``capture_positions``) of the agreeing rays, card against CPU, by
    bounce."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import (Box, box_scene,
                                                 triangle_normals)
    from wayverb_tpu_torch.core.orientation import random_unit_vectors
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer import stochastic, tracer
    box = Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    params = eng.RaytracerParameters(rays=1 << 13, max_time=1.5)
    surfaces = Surface(absorption=torch.tensor([MULTIBAND_ABSORPTION]),
                       scattering=torch.full((1, 8), 0.1))
    depth = eng.optimum_depth(surfaces) // TAIL_DEPTH_CUT
    rays = params.rays
    gen = torch.Generator().manual_seed(SEED)
    init = random_unit_vectors(rays, gen)
    bounce = torch.stack([random_unit_vectors(rays, gen)
                          for _ in range(depth)])
    soup = box_scene(box)
    env = Environment()

    def traced(device, keep=None):
        d = (init, bounce) if keep is None else (init[keep],
                                                 bounce[:, keep])
        r = tracer.trace_jit(
            soup.to(device), surfaces.to(device), src, rcv, None,
            num_rays=rays if keep is None else len(keep), depth=depth,
            max_time=params.max_time, environment=env,
            receiver_radius=params.receiver_radius,
            histogram_sample_rate=params.histogram_sample_rate,
            max_image_source_order=params.maximum_image_source_order,
            directions=d, capture_positions=keep is not None)
        return r

    def tail(hist):
        return stochastic.postprocess(
            hist, params.histogram_sample_rate, Null(), box.volume(), env,
            16000.0, torch.Generator().manual_seed(SEED + 1)).cpu()

    card_t, cpu_t = traced("cuda"), traced("cpu")
    card_h, cpu_h = card_t.histogram.cpu(), cpu_t.histogram
    total = float(cpu_h.sum())
    full_l1 = float((card_h - cpu_h).abs().sum()) / total
    # the same trace again on the card: what its atomic index_add_ order
    # alone moves
    again_l1 = float((traced("cuda").histogram.cpu() - card_h).abs().sum()) \
        / total
    hc, hp = card_t.triangle_history.cpu(), cpu_t.triangle_history
    same = torch.all(hc == hp, dim=0)
    keep = torch.nonzero(same).flatten()
    share = float(same.float().mean())
    # where the others part, and on what
    parting = torch.nonzero(~same).flatten()
    first = torch.argmax((hc[:, parting] != hp[:, parting]).int(), dim=0)
    normals = triangle_normals(soup)
    ta, tb = hc[first, parting].long(), hp[first, parting].long()
    alive = (ta >= 0) & (tb >= 0)
    coplanar = alive & (torch.sum(normals[ta.clamp(min=0)]
                                  * normals[tb.clamp(min=0)], dim=-1) > 0.999)
    card_k, cpu_k = traced("cuda", keep), traced("cpu", keep)
    if not (torch.equal(card_k.triangle_history.cpu(), hc[:, keep])
            and torch.equal(cpu_k.triangle_history, hp[:, keep])):
        _fail("the agreeing rays traced alone changed their histories")
    scale = len(keep) / rays
    kc, kp = card_k.histogram.cpu() * scale, cpu_k.histogram * scale
    kept_l1 = float((kc - kp).abs().sum()) / total
    kept_share = float(kp.sum()) / total
    tc, tp = tail(kc), tail(kp)
    kept_tail = float((tc - tp).abs().max()) / float(tp.abs().max())
    full_tail = float((tail(card_h) - tail(cpu_h)).abs().max()) \
        / float(tail(cpu_h).abs().max())
    drift = (card_k.positions.cpu() - cpu_k.positions).abs() \
        .amax(dim=(1, 2))
    at = [b for b in (0, 7, 15, 31, 63, 127, depth - 1) if b < depth]
    counts = torch.bincount(first, minlength=depth)
    by_decile = [int(counts[i * depth // 10:(i + 1) * depth // 10].sum())
                 for i in range(10)]
    out = {"rays": rays, "depth": depth, "agree_share": share,
           "full_hist_l1": full_l1, "card_again_hist_l1": again_l1,
           "full_tail_rel": full_tail,
           "kept_hist_l1": kept_l1, "kept_energy_share": kept_share,
           "kept_tail_rel": kept_tail,
           "first_parting_bounce": {
               "min": int(first.min()) if len(first) else None,
               "median": int(first.median()) if len(first) else None,
               "by_tenth_of_depth": by_decile},
           "parting_coplanar_share": float(coplanar.float().mean())
           if len(first) else None,
           "kept_position_drift_m": {b: float(drift[b]) for b in at}}
    print(f"[37 tail split] absorption {MULTIBAND_ABSORPTION}, {rays} rays "
          f"x {depth} bounces, card vs CPU, same directions: full "
          f"histograms L1 {full_l1:.3e} of their energy (the card against "
          f"itself, a second trace: {again_l1:.3e}), tail max |d| "
          f"{full_tail:.3e} of peak; triangle histories agree on "
          f"{share:.4f} of the rays (bound {TAIL_AGREE:g}); those rays "
          f"alone: histogram L1 "
          f"{kept_l1:.3e} of the full energy (bound {TAIL_KEPT_L1:g}; they "
          f"carry {kept_share:.4f} of it), tail max |d| {kept_tail:.3e} of "
          f"peak (bound {TAIL_KEPT_REL:g}) [{card}]")
    print(f"[37 tail split] the other {len(parting)} rays first part at "
          f"bounce min {out['first_parting_bounce']['min']}, median "
          f"{out['first_parting_bounce']['median']}, by tenth of the depth "
          f"{by_decile}; coplanar triangles (one wall's two halves) at the "
          f"first parting: {out['parting_coplanar_share']}; reflection "
          f"points of the agreeing rays, card vs CPU, max |d| by bounce "
          f"{ {b: f'{v:.2e}' for b, v in out['kept_position_drift_m'].items()} } "
          f"m [{card}]")
    if not (share >= TAIL_AGREE and kept_l1 <= TAIL_KEPT_L1
            and kept_tail <= TAIL_KEPT_REL):
        _fail("the card's rays part from the CPU's, or deposit otherwise")
    return out


HEAD_REL = 1e-6            # the image-source head card vs CPU, of peak


def _image_sources_card_vs_cpu(torch, card):
    """The image sources of the test_combined box, card against CPU from
    one CPU trace's triangle history (8192 rays at the multiband hall's
    absorption, order 4): the tree, its validation and the direct
    impulse, and each capsule's attenuation (``imagesource.postprocess``'s
    ``attenuate``), to the bit; the head IR within 1e-6 of its peak, with
    its two stages apart on one input: the sinc deposit
    (``sinc_histogram``: elementwise ``cos`` and ``sinc``, which the card
    and the CPU round differently) and the multiband mixdown (FFTs)."""
    from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.orientation import (Orientation,
                                                    random_unit_vectors)
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.imagesource import exact, tree
    from wayverb_tpu_torch.imagesource import postprocess as ipp
    from wayverb_tpu_torch.raytracer import tracer
    from wayverb_tpu_torch.raytracer.histogram import sinc_histogram
    from wayverb_tpu_torch.signal.multiband import \
        multiband_filter_and_mixdown
    soup = box_scene(Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81)))
    surf = Surface(absorption=torch.tensor([MULTIBAND_ABSORPTION]),
                   scattering=torch.full((1, 8), 0.1))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    gen = torch.Generator().manual_seed(SEED + 37)
    # the paths are the histories' first four bounces: eight bounces give
    # the same impulses as the engine's 272
    rays, depth = 1 << 13, 8
    dirs = (random_unit_vectors(rays, gen),
            torch.stack([random_unit_vectors(rays, gen)
                         for _ in range(depth)]))
    history = tracer.trace(soup, surf, src, rcv, None, num_rays=rays,
                           depth=depth, max_time=1.5,
                           max_image_source_order=4,
                           directions=dirs).triangle_history
    methods = {"null": Null(), "cardioid": Microphone(
        Orientation((0.3, 0.2, 0.9)), 0.5), "hrtf0": Hrtf(channel=0),
        "hrtf1": Hrtf(channel=1)}
    runs = {}
    for device in ("cuda", "cpu"):
        imp = tree.find_image_source_impulses(
            history, soup.to(device), surf.to(device), src, rcv,
            max_order=4).concatenate(exact.get_direct(src, rcv,
                                                      soup.to(device)))
        out = {"volume": imp.volume, "position": imp.position,
               "distance": imp.distance}
        for name, m in methods.items():
            v, d = ipp.attenuate(m, rcv, imp)
            out[name + "_volume"], out[name + "_distance"] = v, d
            out[name + "_head"] = ipp.postprocess(imp, m, rcv, 340.0,
                                                  16000.0)
        runs[device] = {k: t.cpu() for k, t in out.items()}
    unequal = sorted(k for k in runs["cpu"] if not k.endswith("_head")
                     and not torch.equal(runs["cuda"][k].view(torch.int32),
                                         runs["cpu"][k].view(torch.int32)))
    d = runs["cpu"]["null_distance"]
    times = d / torch.full_like(d, 340.0)
    bins = int(math.floor(float(times.max()) * 16000.0)) + 1
    hist = sinc_histogram(times, runs["cpu"]["null_volume"], 16000.0, bins)
    hist_card = sinc_histogram(times.cuda(), runs["cpu"]["null_volume"]
                               .cuda(), 16000.0, bins).cpu()
    mix = multiband_filter_and_mixdown(hist.T, 16000.0)
    mix_card = multiband_filter_and_mixdown(hist.T.cuda(), 16000.0).cpu()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    heads = {k[:-5]: rel(runs["cuda"][k], runs["cpu"][k])
             for k in runs["cpu"] if k.endswith("_head")}
    errs = {"impulses": int(runs["cpu"]["volume"].shape[0]),
            "unequal": unequal, "deposit": rel(hist_card, hist),
            "mixdown": rel(mix_card, mix), "heads": heads}
    print(f"[37 multiband card vs cpu] image sources from one CPU history: "
          f"{errs['impulses']} impulses; the tree, validation, direct "
          f"impulse and four capsules' attenuation card vs CPU, outputs "
          f"not bit-equal: {unequal or 'none'} (bound: none); the head IR "
          f"card vs CPU max |d| / peak {heads} (bound {HEAD_REL:g}): on one "
          f"input, the sinc deposit {errs['deposit']:.3e} (elementwise cos "
          f"and sinc) and the mixdown {errs['mixdown']:.3e} (FFTs) [{card}]")
    if unequal or max(heads.values()) > HEAD_REL \
            or max(errs["deposit"], errs["mixdown"]) > HEAD_REL:
        _fail("the image sources on the card differ from the CPU")
    return errs


def phase_multiband_card_vs_cpu(torch, card):
    """The test_combined box of phase 10 with ``bands=2`` on the card and
    on the CPU (same CPU generators), rendered with ``Hrtf(channel=0)``;
    once more at the multiband hall's absorption, to the same bounds, with
    the split of its stochastic tail by ray (``_tail_split``);
    ``Hrtf``'s gains on 65,536 directions card against CPU, to the bit;
    the sharded multiband on four shards of ``cuda:0`` on the shoebox hall
    (32 steps, 2 bands) against the single-device ``canonical_multiband``
    on the same mesh."""
    from wayverb_tpu_torch.core.attenuator import Hrtf
    from wayverb_tpu_torch.core.orientation import Orientation
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    errs = _multiband_card_vs_cpu(torch, ABSORPTION, card)
    print(f"[37 multiband card vs cpu] bounds at absorption {ABSORPTION}: "
          f"bands {WAVEGUIDE_REL:g}, IRs {HYBRID_REL:g} of peak [{card}]")
    if not (all(x <= WAVEGUIDE_REL for x in errs["bands"])
            and errs["hrtf_ir"] <= HYBRID_REL
            and errs["null_ir"] <= HYBRID_REL):
        _fail("the multiband hybrid on the card differs from the CPU run")
    low = _multiband_card_vs_cpu(torch, MULTIBAND_ABSORPTION, card)
    print(f"[37 multiband card vs cpu] bounds at absorption "
          f"{MULTIBAND_ABSORPTION}: bands {WAVEGUIDE_REL:g}, IRs "
          f"{HYBRID_REL:g} of peak [{card}]")
    if not (all(x <= WAVEGUIDE_REL for x in low["bands"])
            and low["hrtf_ir"] <= HYBRID_REL
            and low["null_ir"] <= HYBRID_REL):
        _fail("the low-absorption multiband hybrid on the card differs from "
              "the CPU run")
    low["ray_ops"] = _ray_ops_card_vs_cpu(torch, card)
    low["tail_split"] = _tail_split(torch, card)
    low["image_sources"] = _image_sources_card_vs_cpu(torch, card)

    gen = torch.Generator().manual_seed(SEED + 2)
    dirs = torch.randn(HRTF_DIRECTIONS, 3, generator=gen) \
        * torch.rand(HRTF_DIRECTIONS, 1, generator=gen) * 10.0
    dirs[0] = 0.0
    unequal = 0
    for channel in (0, 1):
        for orientation in (Orientation(),
                            Orientation((0.3, 0.2, 0.9), (0.1, 1.0, 0.0))):
            h = Hrtf(orientation, channel)
            card_g = h.attenuation(dirs.to("cuda")).cpu()
            unequal += int((card_g != h.attenuation(dirs)).sum())
    print(f"[37 multiband card vs cpu] Hrtf.attenuation on "
          f"{HRTF_DIRECTIONS} directions, both ears, two orientations: "
          f"{unequal} gains differ from the CPU's (bound 0) [{card}]")
    if unequal:
        _fail("Hrtf.attenuation on the card differs from the CPU")

    _, dx, mesh, _ = _hall_mesh(torch)
    if mesh.box_spec.dims[0] % SHARDS:
        _fail("the shoebox hall's x does not divide over the shards")
    hsrc, hrcv = _hall_positions(_hall_box(dx), dx)
    absorption = np.asarray([MULTIBAND_ABSORPTION])
    sim = _hall_sim_time(mesh, 32)
    single = wgrun.canonical_multiband(mesh, absorption, hsrc, hrcv, sim, 2)
    fused_step.launches = 0
    t0 = time.perf_counter()
    got = wgrun.canonical_multiband(mesh, absorption, hsrc, hrcv, sim, 2,
                                    device_mesh=_device_mesh())
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    sharded_rel = max(float((g.pressure - s.pressure).abs().max())
                      / float(s.pressure.abs().max())
                      for g, s in zip(got, single))
    print(f"[37 multiband card vs cpu] sharded multiband, hall "
          f"{mesh.box_spec.dims} on {SHARDS} x cuda:0, 2 bands x 32 steps, "
          f"{sharded_s:.2f} s, {fused_step.launches} B1 launches, against the "
          f"single-device canonical_multiband: max |dp| / peak "
          f"{sharded_rel:.3e} (bound {BOX_SHARDED_REL:g}) [{card}]")
    if not (all(bool(g.stable) for g in got)
            and [g.valid_hz for g in got] == [s.valid_hz for s in single]
            and fused_step.launches == 2 * SHARDS * 32
            and sharded_rel <= BOX_SHARDED_REL):
        _fail("the sharded multiband differs from the single-device run")
    return {"phase10_absorption": errs, "multiband_absorption": low,
            "hrtf_gains_unequal": unequal, "sharded_rel_err": sharded_rel,
            "sharded_s": sharded_s}


# ---------------------------------------------------------------------------
# the gradient path: B5, B6, B7

def _bound(n_bytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate (``tools.roofline``)."""
    from wayverb_tpu_torch.tools import roofline
    us, by = roofline.bound_us(n_bytes, flops)
    return us / 1e3, by


def kernel_bounds(spec, order, k):
    """Bounds per step (B5) or per sub-step of a K = CHUNK chunk (B2, B6,
    B7) at ``spec``, from the shapes alone (B1's and B5's are
    ``mega_timing.b1_bound`` and ``b5_bound``).
    Stencil: 6 adds, a multiply and a subtract per node; the adjoint's node
    update: 6 adds, a multiply, an add and a negation."""
    from wayverb_tpu_torch.tools.mega_timing import b5_bound
    from wayverb_tpu_torch.waveguide.box_fused import stacked_plane_shape
    X, Y, Z = spec.dims
    n = X * Y * Z
    Umax, Vmax = stacked_plane_shape(spec)
    plane = 6 * Umax * Vmax
    f = 4                                               # bytes per float32
    out = {}
    b5_us, b5_by = b5_bound(spec.dims)
    out["b5"] = (b5_us / 1e3, b5_by)
    # a chunk: cur, prev, state, planes in and out, signal in, taps out
    chunk_io = f * (4 * n + 2 * (order + 3) * plane + CHUNK * (1 + k))
    out["b2"] = _bound(chunk_io / CHUNK, 8 * n + 40 * plane)
    out["b6"] = _bound(chunk_io / CHUNK + f * 4 * plane, 8 * n + 40 * plane)
    # B7: gnext, gcur, gst in and out, gtaps in, gsig and both streams out
    bwd_io = f * (4 * n + 2 * order * plane + CHUNK * (1 + k))
    out["b7"] = _bound(bwd_io / CHUNK + f * (1 + order) * plane,
                       9 * n + 60 * plane)
    # with the fields streamed through device memory every sub-step
    state = f * (2 * order + 5) * plane     # PL, INS, PRVP, st in; PL, INS, st out
    out["b2_stream"] = _bound(f * 3 * n + state, 0)[0]
    out["b6_stream"] = _bound(f * 3 * n + state + f * 4 * plane, 0)[0]
    # B7's plane streams: ĝst in and out, ĝst′ and ĝpplus out, and 4 plane
    # stacks of scratch, with four fields (P̂, Q̂ read, Q̂, P̂′ written) or, in
    # the two-field form, three (P̂_t, P̂_{t+1} read, R written over P̂_{t+1})
    b7_planes = f * (2 * order + 4 + 1 + order) * plane
    out["b7_stream"] = _bound(f * 4 * n + b7_planes, 0)[0]
    out["b7_stream_two_field"] = _bound(f * 3 * n + b7_planes, 0)[0]
    return out


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def phase_b5_vs_plain(torch, hall_spec, card):
    """fused_step_bwd (CUDA kernel B5) against _fused_step_bwd_plain on the
    same tensors, to the bit (``bits_equal``: NaN for NaN, −0 apart from
    +0) in gcur, gprev, the six plane cotangents and both halo cotangents,
    at the shapes B1 is checked at, on random, 1e38 / ±inf / NaN and all −0
    cotangents.  Returns the largest finite |kernel − plain| (0.0 when all
    agree to the bit)."""
    from wayverb_tpu_torch.tools.mega_timing import b5_equal
    from wayverb_tpu_torch.tools.mesh_timing import case_g
    from wayverb_tpu_torch.waveguide.box_fused import BoxSpec, _plane_shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    s16 = BoxSpec(dims=(16, 16, 128), ilo=(2, 2, 2), ihi=(13, 13, 125),
                  face_surface=(0,) * 6)
    s16x = BoxSpec(dims=(20, 16, 128), ilo=(6, 2, 2), ihi=(17, 13, 125),
                   face_surface=(0,) * 6)
    s37 = BoxSpec(dims=(37, 29, 53), ilo=(2, 3, 2), ihi=(33, 25, 50),
                  face_surface=(0,) * 6)
    hx, hy, hz = hall_spec.dims
    cases = [
        (s16, 0, (8, 9, 64), 0, "random", "no injection"),
        (s16, 0, (8, 9, 64), 1, "random", "hard source deep inside"),
        (s16, 0, (2, 9, 64), 2, "random", "soft source on the inner x plane"),
        (s16, 0, (9, 4, 125), 1, "random", "source at a thread-block edge"),
        (s16x, 4, (10, 7, 40), 1, "random",
         "x offset 4: the low x plane is elsewhere"),
        (s37, 0, (18, 14, 26), 1, "random", "unaligned 37x29x53"),
        (hall_spec, 0, (hx // 2, hy // 2, hz // 2), 1, "random",
         "hall shape"),
        (s37, 0, (18, 14, 26), 1, "1e38 inf nan",
         "unaligned, 1e38 with inf and NaN"),
        (hall_spec, 0, (hx // 2, hy // 2, hz // 2), 1, "all -0",
         "hall shape, all -0"),
    ]
    worst = 0.0
    for spec, xo, src, mode, kind, what in cases:
        X, Y, Z = spec.dims
        X -= xo
        g = case_g(kind, (X, Y, Z), gen)
        ginner = tuple(case_g(kind, s, gen) for s in _plane_shapes(X, Y, Z))
        res = b5_equal((spec.geom_array(x_offset=xo), g, ginner,
                        src + (mode,)))
        worst = max(worst, res["max_abs_err"])
        print(f"[11 B5] {(X, Y, Z)} mode {mode} ({what}): to the bit in "
              f"gcur, gprev, 6 planes, 2 halos: {res['equal']} (differ: "
              f"{res['differ']}; max finite |kernel - plain| = "
              f"{res['max_abs_err']:.3e})")
        if not res["equal"]:
            _fail(f"B5 disagrees with its plain version: {what}")
    return worst


def phase_b5_time(torch, spec, card):
    """B5 alone at the hall with a hard source at the centre, with the
    stream held (a launch is shorter than the wrapper's host time), beside
    the plain version, its registers, local bytes, CTAs an SM and the
    shares of its warps' paths."""
    from wayverb_tpu_torch.tools.mega_timing import (b5_case, b5_warp_shares,
                                                     device_time_us)
    from wayverb_tpu_torch.waveguide.box_fused import (
        _fused_step_bwd_plain, fused_step_bwd, step_bwd_occupancy)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    args = b5_case(spec, 0, spec.dims[0], gen)
    k_us, host_us = device_time_us(lambda: fused_step_bwd(*args), 200)
    p_us = _cuda_time_us(torch, lambda: _fused_step_bwd_plain(*args), 20)
    occ = step_bwd_occupancy(dims=spec.dims)
    shares = b5_warp_shares(args[0], spec.dims, args[3])
    rate = 12 * args[1].numel() / k_us / 1e3
    print(f"[11 B5] alone at {spec.dims}: kernel {k_us:.2f} us a launch on "
          f"the device with the stream held ({rate:.1f} GB/s at 12 B/node; "
          f"{host_us:.1f} us a call on the host), plain "
          f"version {p_us:.2f} us; {occ['registers']} registers, "
          f"{occ['local_bytes']} B local, {occ['ctas_per_sm']} CTAs of "
          f"{occ['threads']} an SM, {occ['grid']} CTAs; (warp, row) pairs "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + f" [{card}]")
    return {"us": k_us, "host_us": host_us, "plain_us": p_us,
            "occupancy": occ, "warp_shares": shares}


def _grad_chunk_case(torch, tag, what, spec, fb, fa, src, taps, gen):
    """B6 and B7 against their plain versions on one chunk of K = CHUNK from
    random state and random cotangents; returns the largest absolute error
    of B6's residuals and of B7's six outputs.  The gates are relative: each
    output within BWD_REL of its own largest value."""
    from wayverb_tpu_torch.waveguide.box_fused import stacked_plane_shape
    from wayverb_tpu_torch.waveguide.box_mega import (
        _mega_chunk_bwd_plain, _mega_chunk_plain, mega_chunk, mega_chunk_bwd)
    order = fb.shape[1] - 1
    state = _random_chunk_inputs(torch, spec, order, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda")
    args = (spec, sig, fb, fa)
    want = _mega_chunk_plain(*args, *state, src, taps, grad=True)
    b2 = mega_chunk(*args, *(t.clone() for t in state), src, taps)
    got = mega_chunk(*args, *(t.clone() for t in state), src, taps,
                     grad=True)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got[:6], b2))
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(got[:5],
                                                             want[:5]))
    res_err = _rel_err(got[6], want[6])
    res_abs = float((got[6] - want[6]).abs().max())
    print(f"[{tag}] B6 {what}: forward outputs equal B2's: {same}; max "
          f"|forward - plain| = {fwd_err:.3e}; residuals "
          f"{tuple(got[6].shape)}: max |kernel - plain| {res_abs:.3e}, "
          f"{res_err:.3e} of the largest (bound 0: bit-equal)")
    if not (same and fwd_err == 0.0 and res_abs == 0.0):
        _fail(f"B6 disagrees: {what}")
    del want, b2, got

    Umax, Vmax = stacked_plane_shape(spec)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    mask = torch.zeros((6, Umax, Vmax), device="cuda")
    for p in range(6):
        U, V = spec.plane_shape(p)
        mask[p, :U, :V] = 1.0
    cot = (rnd(CHUNK, taps.numel()), rnd(*spec.dims), rnd(*spec.dims),
           (rnd(order, 6, Umax, Vmax) * mask).contiguous())
    want = _mega_chunk_bwd_plain(spec, fb, fa, *cot, src, taps)
    got = mega_chunk_bwd(spec, fb, fa, *(t.clone() for t in cot), src, taps)
    torch.cuda.synchronize()
    names = ("gnext", "gcur", "gst", "gsig", "gp_stream", "gstin_stream")
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, got, want)}
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    per_plane = []
    for a, b, axis in ((got[4], want[4], 1), (got[5], want[5], 2)):
        scale = max(float(b.abs().max()), 1e-30)
        per_plane.append([float((a.select(axis, q) - b.select(axis, q))
                                .abs().max()) / scale for q in range(6)])
    print(f"[{tag}] B7 {what}: of the largest value, "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (bound {BWD_REL:g}); per plane gp_stream "
          + " ".join(f"{e:.1e}" for e in per_plane[0]) + ", gstin_stream "
          + " ".join(f"{e:.1e}" for e in per_plane[1]))
    worst = max(max(errs.values()), max(map(max, per_plane)))
    if not worst <= BWD_REL:
        _fail(f"B7 disagrees with its plain version: {what}")
    return res_abs, bwd_abs


def phase_grad_chunks_vs_plain(torch, hall_mesh, box, dx, card):
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import (BoxSpec,
                                                       face_coefficients)
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    t30_mesh = wgrun.shoebox_mesh(_t30_box()[0], np.full((1, 8), ABSORPTION),
                                  grid_spacing(340.0, 1.0 / FS), FS,
                                  device="cuda")
    fb, fa = face_coefficients(t30_mesh.structure, t30_mesh.box_spec)
    worst6 = worst7 = 0.0

    def case(what, *args):
        nonlocal worst6, worst7
        e6, e7 = _grad_chunk_case(torch, "12 grad", what, *args, gen)
        worst6, worst7 = max(worst6, e6), max(worst7, e7)

    # the unaligned box: a hard source on the inner z plane with a tap at
    # the source node, then a soft source on the inner x plane
    small = BoxSpec(dims=(21, 17, 26), ilo=(2, 3, 2), ihi=(18, 13, 23),
                    face_surface=(0,) * 6)
    X, Y, Z = small.dims
    for loc, mode in (((10, 8, small.ilo[2]), 1), ((small.ihi[0], 8, 12), 2)):
        flat = (loc[0] * Y + loc[1]) * Z + loc[2]
        taps = torch.tensor([flat, flat + 1, flat - Z, 5, X * Y * Z - 1],
                            device="cuda")
        case(f"{small.dims} source {loc} mode {mode}", small, fb, fa,
             loc + (mode,), taps)
    spec = t30_mesh.box_spec
    _, _, src_pos, rcv_pos = _t30_box()
    source, receiver, _, _ = wgrun.canonical_problem(
        t30_mesh, src_pos, rcv_pos, 0.1, Environment())
    src = source.kernel_injection(spec.dims, 0)[0][:3] + (2,)
    case(f"T30 box {spec.dims}, soft source", spec, fb, fa, src,
         receiver.tap_nodes())
    spec = hall_mesh.box_spec
    fb, fa = face_coefficients(hall_mesh.structure, spec)
    src, taps = _hall_chunk_problem(torch, hall_mesh, box, dx)
    case(f"hall {spec.dims}, random state, hall source and taps", spec, fb,
         fa, src, taps)
    return worst6, worst7, (spec, fb, fa, src, taps)


def phase_grad_chunk_time(torch, case, card):
    """B6 and B7 alone at the hall shape, their plain versions, and the
    coefficient gradients of one chunk (plain autograd, no kernel)."""
    from wayverb_tpu_torch.waveguide.box_fused import stacked_plane_shape
    from wayverb_tpu_torch.waveguide.box_mega import (
        _chunk_theta_grads, _mega_chunk_bwd_plain, _mega_chunk_plain,
        mega_chunk, mega_chunk_bwd)
    spec, fb, fa, src, taps = case
    order = fb.shape[1] - 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    state = _random_chunk_inputs(torch, spec, order, gen)
    sig = torch.randn(CHUNK, generator=gen, device="cuda") * 1e-3
    b6_us = _cuda_time_us(torch, lambda: mega_chunk(
        spec, sig, fb, fa, *state, src, taps, grad=True), 5)
    b6_plain_us = _cuda_time_us(torch, lambda: _mega_chunk_plain(
        spec, sig, fb, fa, *state, src, taps, grad=True), 1)
    Umax, Vmax = stacked_plane_shape(spec)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    gtaps = rnd(CHUNK, taps.numel())
    carry = [rnd(*spec.dims) * 1e-3, rnd(*spec.dims) * 1e-3,
             torch.zeros(order, 6, Umax, Vmax, device="cuda")]

    def bwd():
        # the kernel consumes its field and state cotangents: chain them
        carry[:] = mega_chunk_bwd(spec, fb, fa, gtaps, *carry, src, taps)[:3]

    b7_us = _cuda_time_us(torch, bwd, 5)
    b7_plain_us = _cuda_time_us(torch, lambda: _mega_chunk_bwd_plain(
        spec, fb, fa, gtaps, *carry, src, taps), 1)
    res = mega_chunk(spec, sig, fb, fa, *state, src, taps, grad=True)[6]
    streams = mega_chunk_bwd(spec, fb, fa, gtaps, *carry, src, taps)[4:]
    theta_us = _cuda_time_us(torch, lambda: _chunk_theta_grads(
        spec, fb, fa, res, *streams), 3)
    from wayverb_tpu_torch.waveguide.box_mega import (chunk_bwd_occupancy,
                                                      chunk_occupancy)
    occ = chunk_occupancy()
    print(f"[12 grad] B6 is the chunk kernel of phase 7 with a residual "
          f"block: {occ['registers']} registers, {occ['local_bytes']} B "
          f"local, {occ['ctas_per_sm']} CTAs an SM [{card}]")
    b7_occ = chunk_bwd_occupancy()
    print(f"[12 grad] B7, one cooperative launch a chunk: "
          f"{b7_occ['registers']} registers, {b7_occ['local_bytes']} B "
          f"local, {b7_occ['ctas_per_sm']} CTAs an SM, a grid of "
          f"{b7_occ['grid']} CTAs [{card}]")
    print(f"[12 grad] alone at {spec.dims}, K = {CHUNK}: B6 "
          f"{b6_us / CHUNK:.2f} us/sub-step (plain {b6_plain_us / CHUNK:.2f})"
          f", B7 {b7_us / CHUNK:.2f} us/sub-step (plain "
          f"{b7_plain_us / CHUNK:.2f}); per chunk B6 {b6_us / 1e3:.3f} ms, "
          f"B7 {b7_us / 1e3:.3f} ms, the coefficient gradients "
          f"(_chunk_theta_grads, plain autograd) {theta_us / 1e3:.3f} ms "
          f"[{card}]")
    return b6_us, b6_plain_us, b7_us, b7_plain_us, theta_us, b7_occ


def _grad_counts():
    from wayverb_tpu_torch.waveguide.box_fused import (fused_step,
                                                       fused_step_bwd)
    from wayverb_tpu_torch.waveguide.box_mega import (mega_chunk,
                                                      mega_chunk_bwd)
    return {"box_fused_step": fused_step.launches,
            "box_fused_step_bwd": fused_step_bwd.launches,
            "box_mega_chunk": mega_chunk.launches,
            "box_mega_chunk_grad": mega_chunk.grad_launches,
            "box_mega_chunk_bwd": mega_chunk_bwd.launches}


def _reset_grad_counts():
    from wayverb_tpu_torch.waveguide.box_fused import (fused_step,
                                                       fused_step_bwd)
    from wayverb_tpu_torch.waveguide.box_mega import (mega_chunk,
                                                      mega_chunk_bwd)
    fused_step.launches = fused_step_bwd.launches = 0
    mega_chunk.launches = mega_chunk.grad_launches = 0
    mega_chunk_bwd.launches = 0


def _leaves(mesh, source):
    """(structure, source) whose coefficients and signal are fresh leaves
    that require grad, and the leaves (coef_b, coef_a, signal)."""
    import dataclasses
    cb = mesh.structure.coef_b.detach().clone().requires_grad_(True)
    ca = mesh.structure.coef_a.detach().clone().requires_grad_(True)
    sig = source.signal.detach().clone().requires_grad_(True)
    return (dataclasses.replace(mesh.structure, coef_b=cb, coef_a=ca),
            dataclasses.replace(source, signal=sig), (cb, ca, sig))


def _mega_grads(torch, mesh, source, receiver, steps, chunk, timed=False,
                only_signal=False):
    """Value and gradients of Σ taps² through mega_canonical_loss_fn;
    ``only_signal``: the coefficients do not require grad."""
    from wayverb_tpu_torch.waveguide.box_fused import face_coefficients
    from wayverb_tpu_torch.waveguide.box_mega import mega_canonical_loss_fn
    structure, source, leaves = _leaves(mesh, source)
    if only_signal:
        structure, leaves = mesh.structure, leaves[2:]
    f = mega_canonical_loss_fn(structure, mesh.box_spec, source, receiver,
                               steps, chunk)
    sync = torch.cuda.synchronize if timed else (lambda: None)
    sync()
    t0 = time.perf_counter()
    taps, stable = f(*face_coefficients(structure, mesh.box_spec),
                     source.signal)
    loss = torch.sum(taps ** 2)
    sync()
    t1 = time.perf_counter()
    loss.backward()
    sync()
    t2 = time.perf_counter()
    return (float(loss.detach()), bool(stable),
            tuple(t.grad.detach() for t in leaves), t1 - t0, t2 - t1)


def _fused_grads(torch, mesh, source, receiver, steps):
    """The same through run_waveguide_box(kernel_inject=False): B1 forward,
    B5 backward, exact signal gradients."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    structure, source, leaves = _leaves(mesh, source)
    out = wgrun.run_waveguide_box(structure, mesh.box_spec, source, receiver,
                                  steps, kernel_inject=False)
    loss = torch.sum(out["outputs"] ** 2)
    loss.backward()
    return float(loss.detach()), tuple(t.grad.detach() for t in leaves)


def _tap_receiver(receiver):
    """A receiver whose outputs are the raw taps of ``receiver``'s nodes, so
    both routes give Σ taps² the same meaning."""
    from wayverb_tpu_torch.waveguide.receivers import MultiNodeReceiver
    return MultiNodeReceiver(node_idx=receiver.tap_nodes().reshape(-1))


def phase_grad_hall(torch, box, dx, mesh, card):
    """The gradient path at full width: the hall, GRAD_STEPS steps."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    src, rcv = _hall_positions(box, dx)
    nodes = mesh.descriptor.num_nodes
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, src, rcv, _hall_sim_time(mesh, GRAD_STEPS))
    # warm-up: one chunk forward and backward
    _mega_grads(torch, mesh, source, receiver, CHUNK, CHUNK)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_grad_counts()
    loss, stable, grads, t_fwd, t_bwd = _mega_grads(
        torch, mesh, source, receiver, n, CHUNK, timed=True)
    counts = _grad_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    # the run above allocated from an emptied cache; again with the blocks
    # it left, and once with only the signal requiring grad (the backward
    # then skips the coefficient gradients)
    _, _, _, t_fwd_warm, t_bwd_warm = _mega_grads(
        torch, mesh, source, receiver, n, CHUNK, timed=True)
    torch.cuda.reset_peak_memory_stats()
    _, _, (gsig_only,), t_fwd_sig, t_bwd_sig = _mega_grads(
        torch, mesh, source, receiver, n, CHUNK, timed=True,
        only_signal=True)
    peak_sig = torch.cuda.max_memory_allocated()
    # the backward's device launches: one B7 kernel a chunk
    from wayverb_tpu_torch.tools.mega_timing import profile
    prof = profile(lambda: _mega_grads(torch, mesh, source, receiver, n,
                                       CHUNK), "mega_chunk_bwd_kernel")
    bwd_kernels = {k: v for k, v in prof["kernels"].items() if "bwd" in k}
    sig_rel = _rel_err(gsig_only, grads[2])
    sig_same = sig_rel <= GRAD_REL
    chunks = -(-n // CHUNK)
    names = ("coef_b", "coef_a", "signal")
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = all(float(g.abs().max()) > 0 for g in grads)
    print(f"[13 grad hall] {mesh.descriptor.dimensions}, {n} steps, K = "
          f"{CHUNK}: loss {loss:.6e}, stable {stable}, gradients finite "
          f"{finite}, nonzero {nonzero}; "
          + ", ".join(f"max |d/d{nm}| {float(g.abs().max()):.4e}"
                      for nm, g in zip(names, grads)))
    print(f"[13 grad hall] launches {counts} (expected {chunks} grad-mode "
          f"chunks, {chunks} backward chunks, 0 plain chunks)")
    print(f"[13 grad hall] forward in grad mode {t_fwd:.4f} s "
          f"({1e3 * t_fwd / n:.4f} ms/step), backward {t_bwd:.4f} s "
          f"({1e3 * t_bwd / n:.4f} ms/step), {nodes * n / (t_fwd + t_bwd):.4e}"
          f" node-updates/s forward+backward, peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    print(f"[13 grad hall] again with a warm allocator: forward "
          f"{t_fwd_warm:.4f} s, backward {t_bwd_warm:.4f} s; only the signal "
          f"requires grad: forward {t_fwd_sig:.4f} s, backward "
          f"{t_bwd_sig:.4f} s, peak memory {peak_sig / 2**20:.1f} MiB, "
          f"d/dsignal vs the full run's {sig_rel:.3e} of the largest "
          f"(bound {GRAD_REL:g}) [{card}]")
    print(f"[13 grad hall] one run under the profiler: "
          f"{prof['chunk_launches']} device launches of B7's kernel for "
          f"{chunks} backward chunks; the adjoint kernels by name "
          f"[launches, device us]: {bwd_kernels} [{card}]")
    if not (n == GRAD_STEPS and stable and finite and nonzero and sig_same
            and counts["box_mega_chunk_grad"] == chunks
            and counts["box_mega_chunk_bwd"] == chunks
            and counts["box_mega_chunk"] == 0
            and prof["chunk_launches"] == chunks
            and len(bwd_kernels) == 1):
        _fail("the hall gradient run failed its checks")
    return (counts, t_fwd, t_bwd, peak_mem,
            {"warm_forward_s": t_fwd_warm, "warm_backward_s": t_bwd_warm,
             "signal_only_forward_s": t_fwd_sig,
             "signal_only_backward_s": t_bwd_sig,
             "signal_only_peak_memory_bytes": peak_sig,
             "b7_device_launches": prof["chunk_launches"]})


def _compare_grads(tag, what, got, want):
    names = ("coef_b", "coef_a", "signal")
    rels = [_rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want)]
    print(f"[{tag}] {what}: "
          + ", ".join(f"d/d{n} {r:.3e}" for n, r in zip(names, rels))
          + f" of the largest component (bound {GRAD_REL:g})")
    if not max(rels) <= GRAD_REL:
        _fail(f"gradients disagree: {what}")
    return max(rels)


def phase_grad_routes(torch, mesh, card):
    """Mega route (B6, B7) against the fused route with kernel_inject=False
    (B1, B5) on the hall, 16 steps, K = 8.  The source sits 3 nodes from
    the low x wall (with the taps around a node 2 further in), so that the
    wave meets the boundary filters within the 16 steps and the coefficient
    gradients are not trivially zero."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    steps = 16
    spec, desc = mesh.box_spec, mesh.descriptor
    mid = [(spec.ilo[a] + spec.ihi[a]) // 2 for a in range(3)]
    src = tuple(desc.position(np.array([spec.ilo[0] + 3, mid[1], mid[2]])))
    rcv = tuple(desc.position(np.array([spec.ilo[0] + 5, mid[1], mid[2]])))
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, src, rcv, _hall_sim_time(mesh, steps))
    receiver = _tap_receiver(receiver)
    _reset_grad_counts()
    loss_m, stable, g_mega, _, _ = _mega_grads(torch, mesh, source, receiver,
                                               n, 8)
    mega_counts = _grad_counts()
    _reset_grad_counts()
    loss_f, g_fused = _fused_grads(torch, mesh, source, receiver, n)
    torch.cuda.synchronize()
    fused_counts = _grad_counts()
    print(f"[14 routes] hall, {n} steps, source 3 nodes from the low x wall: "
          f"mega route loss {loss_m:.6e} with launches {mega_counts}; fused "
          f"route loss {loss_f:.6e} with launches {fused_counts}; largest "
          "gradient components "
          + ", ".join(f"{float(g.abs().max()):.4e}" for g in g_fused))
    rel = _compare_grads("14 routes", "mega route vs fused route on the card",
                         g_mega, g_fused)
    if not (stable and all(float(g.abs().max()) > 0 for g in g_fused)
            and mega_counts["box_mega_chunk_grad"] == 2
            and mega_counts["box_mega_chunk_bwd"] == 2
            and fused_counts["box_fused_step"] == n
            and fused_counts["box_fused_step_bwd"] >= n - 1
            and fused_counts["box_mega_chunk_grad"] == 0):
        _fail("a gradient route did not launch its kernels, or a gradient "
              "is all zero")
    return fused_counts, rel


def phase_grad_card_vs_cpu(torch, card):
    """Gradients on the card (both routes) against the plain versions on
    the CPU, on the box of the CPU tests (1.4 x 1.6 x 1.8 m)."""
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    steps = 24
    box = Box((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
    results = {}
    for device in ("cuda", "cpu"):
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.12), dx, fs,
                                  device=device)
        source, receiver, n, _ = wgrun.canonical_problem(
            mesh, (0.7, 0.8, 0.5), (0.7, 0.8, 1.3), (steps - 0.5) / fs)
        receiver = _tap_receiver(receiver)
        _reset_grad_counts()
        t0 = time.perf_counter()
        _, _, g_mega, _, _ = _mega_grads(torch, mesh, source, receiver, n, 8)
        counts = _grad_counts()
        if device == "cuda":
            results["cuda fused"] = _fused_grads(torch, mesh, source,
                                                 receiver, n)[1]
        elif any(counts.values()):
            _fail("a kernel was counted on CPU tensors")
        results[device] = g_mega
        print(f"[15 card vs cpu] {mesh.descriptor.dimensions}, {n} steps on "
              f"{device}: {time.perf_counter() - t0:.2f} s, launches "
              f"{counts}")
    a = _compare_grads("15 card vs cpu", "mega route on the card vs plain "
                       "versions on the CPU", results["cuda"], results["cpu"])
    b = _compare_grads("15 card vs cpu", "fused route on the card vs plain "
                       "versions on the CPU", results["cuda fused"],
                       results["cpu"])
    return max(a, b)


def phase_descent(torch, card):
    """Three plain gradient steps on a scale of the filter numerators toward
    the response of a more absorbent T30 box lower the loss each time."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import face_coefficients
    from wayverb_tpu_torch.waveguide.box_mega import mega_canonical_loss_fn
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    box, _, src, rcv = _t30_box()
    dx = grid_spacing(340.0, 1.0 / FS)
    steps = 256
    meshes = [wgrun.shoebox_mesh(box, np.full((1, 8), a), dx, FS,
                                 device="cuda") for a in (ABSORPTION, 0.3)]
    source, receiver, n, _ = wgrun.canonical_problem(
        meshes[0], src, rcv, (steps - 0.5) / FS)

    def taps_of(mesh, scale):
        f = mega_canonical_loss_fn(mesh.structure, mesh.box_spec, source,
                                   receiver, n, CHUNK)
        fb, fa = face_coefficients(mesh.structure, mesh.box_spec)
        return f(fb * scale, fa, source.signal)[0]

    with torch.no_grad():
        target = taps_of(meshes[1], 1.0)
    scale = torch.ones((), device="cuda", requires_grad=True)
    losses, lr = [], None
    for _ in range(4):
        loss = torch.sum((taps_of(meshes[0], scale) - target) ** 2)
        g, = torch.autograd.grad(loss, scale)
        if lr is None:
            lr = 0.05 / abs(float(g))      # the first step moves by 0.05
        losses.append(float(loss.detach()))
        scale = (scale - lr * g).detach().requires_grad_(True)
    print(f"[16 descent] T30 box, {n} steps, absorption {ABSORPTION} toward "
          f"0.3: loss {' -> '.join(f'{v:.6e}' for v in losses)}, scale "
          f"{float(scale.detach()):.4f} [{card}]")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        _fail("gradient descent did not lower the loss at every step")


# ---------------------------------------------------------------------------
# the general (arbitrary-geometry) mesh: B8, B9, B12

def _columns_spacing(cutoff):
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    fs = cutoff / (0.25 * 0.6)
    return fs, grid_spacing(340.0, 1.0 / fs)


def _columns_mesh(torch, cutoff, device, timings=None):
    """The hall with columns, meshed as ``Engine`` meshes it at ``cutoff``
    (no ``scene_box``: the general path)."""
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    from wayverb_tpu_torch.waveguide import run as wgrun
    fs, dx = _columns_spacing(cutoff)
    soup, n_tri = procedural_hall(2, 4, 1)
    if n_tri != 96:
        _fail(f"the columns hall has {n_tri} triangles, expected 96")
    return wgrun.compute_mesh(soup, np.full((1, 8), ABSORPTION), dx, fs,
                              device=device, timings=timings)


def _mesh_kernel_case(torch, tag, what, cur, prev, g, code, mask):
    """B8, B9 and B12 against their plain versions on the same CUDA
    tensors, B9 to the bit (``mesh_timing.bits_equal``: NaN for NaN, −0
    apart from +0); returns the three max |kernel - plain|."""
    from wayverb_tpu_torch.tools.mesh_timing import bits_equal
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    pairs = (
        ("B8", sk.weighted_step(cur, prev, code),
         sk._weighted_step_plain(cur, prev, code)),
        ("B9", sk.weighted_step_bwd(g, code),
         sk._weighted_step_bwd_plain(g, code)),
        ("B12", sk.interior_step(cur, prev, mask),
         sk._interior_step_plain(cur, prev, mask)))
    torch.cuda.synchronize()
    errs = []
    for name, got, want in pairs:
        err = float((got - want).abs().max())
        peak = float(want.abs().max())
        errs.append(err)
        equal = name != "B9" or bits_equal(got, want)
        note = f"; to the bit: bit-equal {equal}" if name == "B9" else ""
        print(f"[{tag}] {name} {tuple(cur.shape)} ({what}): max |kernel - "
              f"plain| = {err:.3e}, peak {peak:.3e} (bound {MESH_REL:g} x "
              f"peak{note})")
        if not (err <= MESH_REL * peak and peak > 0 and equal):
            _fail(f"{name} disagrees with its plain version: {what}")
    return errs


def phase_mesh_kernels_vs_plain(torch, structure, card):
    """B8, B9, B12 against their plain versions: odd and tile-like dims with
    random 13-bit codes and masks, then the columns hall's shape with random
    codes and with the hall's own weight code and interior mask; B9 to the
    bit, and on the hall's own code also at 1e38 with ±inf and NaN, all −0,
    and its slices of Y·Z < 32, of one and two rows and of odd Y."""
    from wayverb_tpu_torch.tools.mesh_timing import (bare_warps, bits_equal,
                                                     case_g)
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rnd = lambda dims: torch.randn(*dims, generator=gen,  # noqa: E731
                                   device="cuda")

    def random_tables(dims):
        code = torch.randint(0, 1 << 13, dims, generator=gen, device="cuda",
                             dtype=torch.int32)
        mask = (torch.rand(*dims, generator=gen, device="cuda") > 0.3).float()
        return code, mask

    hall = tuple(structure.weight_code.shape)
    worst = [0.0, 0.0, 0.0]
    cases = [((6, 7, 9), "odd dims, random codes"),
             ((37, 29, 53), "odd dims, random codes"),
             ((3, 2, 300), "a ragged z block, random codes"),
             ((16, 8, 128), "tile-like dims, random codes"),
             ((32, 16, 256), "tile-like dims, random codes"),
             (hall, "columns hall shape, random codes")]
    for dims, what in cases:
        errs = _mesh_kernel_case(torch, "17 mesh", what, rnd(dims), rnd(dims),
                                 rnd(dims), *random_tables(dims))
        worst = [max(a, b) for a, b in zip(worst, errs)]
    errs = _mesh_kernel_case(
        torch, "17 mesh", "the columns hall's own weight code and mask",
        rnd(hall), rnd(hall), rnd(hall), structure.weight_code,
        structure.interior_mask)
    code = structure.weight_code
    warps = bare_warps(code)
    print(f"[17 mesh] B9 on the hall's own code: {int(warps.sum())} of "
          f"{warps.numel()} warps bare")
    if not 0 < int(warps.sum()) < warps.numel():
        _fail("the columns hall's code gives B9 no bare or no general warp")
    for cut, kind, what in (
            (None, "1e38 inf nan", "g at 1e38 with inf and NaN"),
            (None, "all -0", "g all -0"),
            ((slice(0, 4), slice(60, 63), slice(100, 105)), "random",
             "a slice of it with Y*Z < 32"),
            ((slice(170, 171),), "random", "one row of it"),
            ((slice(170, 172),), "random", "two rows of it"),
            ((slice(100, 140), slice(0, 67)), "1e38 inf nan",
             "40 rows of odd Y, g at 1e38 with inf and NaN")):
        c = code if cut is None else code[cut].contiguous()
        g = case_g(kind, tuple(c.shape), gen)
        got = sk.weighted_step_bwd(g, c)
        want = sk._weighted_step_bwd_plain(g, c)
        torch.cuda.synchronize()
        equal = bits_equal(got, want)
        print(f"[17 mesh] B9 {tuple(c.shape)} (the hall's own code, {what}): "
              f"bit-equal {equal}")
        if not equal:
            _fail(f"B9 differs from its plain version: {what}")
    return [max(a, b) for a, b in zip(worst, errs)]


def mesh_kernel_bounds(dims):
    """(bound_ms, bound_by) per step of B8, B9 and B12 on a grid of
    ``dims``, from ``mesh_timing.mesh_bounds``: B8 reads cur, prev and the
    int32 code and writes out, 15 operations a node; B9 reads g and the
    code and writes gcur, 13 operations a node; B12 reads cur, prev and the
    mask and writes out, 9 operations a node."""
    from wayverb_tpu_torch.tools.mesh_timing import mesh_bounds
    return {k: (us / 1e3, by) for k, (us, by) in mesh_bounds(dims).items()}


def phase_mesh_kernel_times(torch, structure, card):
    """B8, B9, B12 alone at the columns hall's shape, and their plain
    versions (CUDA events), with the hall's own code and mask; B9's
    registers, local bytes, CTAs an SM and the share of its warps on the
    bare path."""
    from wayverb_tpu_torch.tools.mesh_timing import bare_warps
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    code, mask = structure.weight_code, structure.interior_mask
    dims = tuple(code.shape)
    n = code.numel()
    cur, prev, g = (torch.randn(*dims, generator=gen, device="cuda")
                    for _ in range(3))
    out = torch.empty_like(cur)
    bounds = mesh_kernel_bounds(dims)
    times = {}
    for name, per_node, kernel, plain in (
            ("b8", 16, lambda: sk.weighted_step(cur, prev, code, out=out),
             lambda: sk._weighted_step_plain(cur, prev, code)),
            ("b9", 12, lambda: sk.weighted_step_bwd(g, code),
             lambda: sk._weighted_step_bwd_plain(g, code)),
            ("b12", 16, lambda: sk.interior_step(cur, prev, mask, out=out),
             lambda: sk._interior_step_plain(cur, prev, mask))):
        k_us = _cuda_time_us(torch, kernel, 200)
        p_us = _cuda_time_us(torch, plain, 20)
        times[name] = (k_us, p_us)
        print(f"[18 mesh] {name.upper()} alone at {dims} = {n} nodes: kernel "
              f"{k_us:.2f} us/step ({per_node * n / k_us / 1e3:.1f} GB/s at "
              f"{per_node} B/node), plain version {p_us:.2f} us/step, bound "
              f"{1e3 * bounds[name][0]:.2f} us by {bounds[name][1]} [{card}]")
    occ = sk.bwd_occupancy(dims=dims)
    share = float(bare_warps(code).float().mean())
    print(f"[18 mesh] B9: {share:.4f} of its warps on the hall's code take "
          f"the bare path; {occ['registers']} registers, "
          f"{occ['local_bytes']} B local, {occ['ctas_per_sm']} CTAs of "
          f"{occ['threads']} an SM, {occ['grid']} CTAs a launch [{card}]")
    return times, bounds, {**occ, "bare_warp_share": share}


def _mesh_counts():
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    return {"mesh_weighted_step": sk.weighted_step.launches,
            "mesh_weighted_step_bwd": sk.weighted_step_bwd.launches,
            "mesh_interior_step": sk.interior_step.launches}


def _reset_mesh_counts():
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    sk.weighted_step.launches = sk.weighted_step_bwd.launches = 0
    sk.interior_step.launches = 0
    _reset_grad_counts()


def phase_columns_hall(torch, mesh, timings, setup_s, card):
    """The columns hall through ``canonical`` on the card, 1000 steps."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    desc = mesh.descriptor
    nodes = desc.num_nodes
    steps = COLUMNS_STEPS
    sim_time = (steps - 0.5) / COLUMNS_FS
    b = mesh.structure.num_boundary_nodes
    reentrant = int(((mesh.structure.interior_mask > 0).cpu().numpy()
                     & ~mesh.inside).sum())
    print(f"[19 columns] {desc.dimensions} = {nodes} nodes, "
          f"{int(mesh.inside.sum())} inside, {b} boundary, {reentrant} "
          f"reentrant; setup {setup_s:.2f} s: classification "
          f"{timings['classify_s']:.2f} s by {timings['classifier']}, filter "
          f"fit {timings['fit_s']:.2f} s, structure "
          f"{timings['structure_s']:.2f} s")
    if mesh.box_spec is not None or mesh.regions is not None \
            or reentrant == 0:
        _fail("the columns hall is not a general mesh")
    wgrun.canonical(mesh, COLUMNS_SRC, COLUMNS_RCV, 15.5 / COLUMNS_FS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_mesh_counts()
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, COLUMNS_SRC, COLUMNS_RCV, sim_time)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**_mesh_counts(), **_grad_counts()}
    peak_mem = torch.cuda.max_memory_allocated()
    n = out.pressure.shape[0]
    finite = bool(torch.isfinite(out.pressure).all()
                  and torch.isfinite(out.intensity).all())
    stable = bool(out.stable)
    peak = float(out.pressure.abs().max())
    print(f"[19 columns] {n} steps: stable {stable}, finite {finite}, peak "
          f"|p| {peak:.4f}, launches {counts}")
    others = sum(v for k, v in counts.items() if k != "mesh_weighted_step")
    if not (n == steps and stable and finite and peak > 0 and others == 0
            and counts["mesh_weighted_step"] == steps):
        _fail("the columns hall run failed its checks")
    print(f"[19 columns] general path wall {1e3 * wall / steps:.4f} ms/step,"
          f" {nodes * steps / wall:.4e} node-updates/s, peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    prof = _profile_window(
        torch, "19 profile",
        lambda: wgrun.canonical(mesh, COLUMNS_SRC, COLUMNS_RCV,
                                31.5 / COLUMNS_FS), 32, wall / steps, card)
    if prof is not None:
        b8_us = sum(t for key, t in prof[3].items()
                    if "mesh_weighted_step_kernel" in key)
        print(f"[19 profile] of the unprofiled {1e6 * wall / steps:.1f} "
              f"us/step: B8 {b8_us:.1f} us, the other device kernels (the "
              f"compact boundary pass, the isfinite check, injection, taps) "
              f"{prof[0] - b8_us:.1f} us, device idle "
              f"{1e6 * wall / steps - prof[0]:.1f} us [{card}]")
    return {"dims": list(desc.dimensions), "nodes": nodes, "steps": steps,
            "boundary_nodes": b, "wall_ms_per_step": 1e3 * wall / steps,
            "peak_memory_bytes": peak_mem, "setup_s": setup_s, **timings,
            "profile": None if prof is None else {
                "device_busy_us_per_step": prof[0],
                "b8_us_per_step": b8_us,
                "kernels_per_step": prof[1], "idle_share": prof[2]}}


def phase_general_physics(torch, t30_mesh, t30_src, t30_rcv, sabine, card):
    """The T30 box as a general mesh against Sabine and the mega path; a
    thin box through the region path against its CPU run."""
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    env = Environment()
    dx = grid_spacing(env.speed_of_sound, 1.0 / FS)
    box = _t30_box()[0]
    absorption = np.full((1, 8), ABSORPTION)
    # anchored as the shoebox mesh is, so both grids hold the same nodes
    mesh = wgrun.compute_mesh(box_scene(box), absorption, dx, FS,
                              anchor=tuple(np.asarray(box.centre())),
                              device="cuda")
    if mesh.box_spec is not None or mesh.regions is not None:
        _fail("the T30 box without scene_box did not build a general mesh")
    if mesh.descriptor != t30_mesh.descriptor or \
            int((mesh.inside != t30_mesh.inside).sum()):
        _fail("the general T30 mesh differs from the shoebox mesh: "
              f"{mesh.descriptor} vs {t30_mesh.descriptor}")
    _reset_mesh_counts()
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, t30_src, t30_rcv, T30_TIME, env)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _mesh_counts()
    _t30_of(out, sabine, "20 t30 general", dt, card)
    ref = wgrun.canonical(t30_mesh, t30_src, t30_rcv, T30_TIME, env)
    peak = float(ref.pressure.abs().max())
    err = float((out.pressure - ref.pressure).abs().max())
    print(f"[20 t30 general] {counts['mesh_weighted_step']} B8 launches; "
          f"general path vs mega path: max |Δp| {err:.3e} = "
          f"{err / peak:.3e} of peak (bound {GENERAL_VS_MEGA_REL:g})")
    if not (counts["mesh_weighted_step"] == out.pressure.shape[0]
            and err <= GENERAL_VS_MEGA_REL * peak):
        _fail("the general path on the T30 box failed its checks")

    # a box two nodes thin in z: too thin for the plane solver
    thin = Box((0.0, 0.0, 0.0), (1.4, 1.6, 0.5))
    outs = []
    for device in ("cuda", "cpu"):
        m = wgrun.shoebox_mesh(thin, absorption, dx, FS,
                               anchor=(0.7, 0.8, 0.25 + dx / 2),
                               device=device)
        if m.box_spec is not None or m.regions is None:
            _fail("the thin box did not route to the region path")
        _reset_mesh_counts()
        outs.append(wgrun.canonical(m, (0.5, 0.6, 0.2), (0.9, 1.1, 0.3),
                                    0.09, env))
        n_b12 = _mesh_counts()["mesh_interior_step"]
        if n_b12 != (outs[-1].pressure.shape[0] if device == "cuda" else 0):
            _fail(f"thin box on {device}: {n_b12} B12 launches")
        if device == "cuda":
            thin_launches = n_b12
            # B12 at the shape and with the mask the region path gives it
            gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
            fields = [torch.randn(*m.descriptor.dimensions, generator=gen,
                                  device="cuda") for _ in range(3)]
            thin_err = _mesh_kernel_case(
                torch, "20 thin box", "the thin box's own weight code and "
                "mask", *fields, m.structure.weight_code,
                m.structure.interior_mask)[2]
    peak = float(outs[1].pressure.abs().max())
    err = float((outs[0].pressure.cpu() - outs[1].pressure).abs().max())
    print(f"[20 thin box] {m.descriptor.dimensions}, "
          f"{outs[0].pressure.shape[0]} steps through the region path: "
          f"{thin_launches} B12 launches on the card, 0 on the CPU; card vs "
          f"CPU max |Δp| {err:.3e} = {err / peak:.3e} of peak (bound "
          f"{WAVEGUIDE_REL:g})")
    if not (bool(outs[0].stable) and bool(outs[1].stable)
            and err <= WAVEGUIDE_REL * peak):
        _fail("the thin box failed its checks")
    return thin_launches, thin_err


def _columns_engine(torch, cutoff, device):
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    surfaces = Surface(absorption=torch.full((1, 8), ABSORPTION),
                       scattering=torch.full((1, 8), 0.1))
    return eng.Engine(procedural_hall(2, 4, 1)[0], surfaces,
                      eng.WaveguideParameters(cutoff=cutoff,
                                              usable_portion=0.6),
                      device=device)


def phase_hybrid_columns(torch, checked_code, card):
    """Engine (no scene_box) .run + render + render_all on the columns hall;
    seconds of each phase.  ``checked_code``: the weight code phase 17
    checked B8 on.  Returns the launch counts of the run."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Microphone, Null
    t0 = time.perf_counter()
    e = _columns_engine(torch, COLUMNS_CUTOFF, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    code = e.mesh.structure.weight_code
    if code.shape != checked_code.shape or not torch.equal(code,
                                                           checked_code):
        _fail(f"the engine's weight code {tuple(code.shape)} is not the one "
              f"phase 17 checked, {tuple(checked_code.shape)}")
    params = eng.RaytracerParameters()
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    _reset_mesh_counts()
    mark("start")
    results = e.run(COLUMNS_SRC, COLUMNS_RCV, gen, params,
                    waveguide_time=COLUMNS_STEPS / COLUMNS_FS,
                    state_callback=mark)
    mark("end")
    launches = {**_mesh_counts(), **_grad_counts()}
    t_render = time.perf_counter()
    ir = eng.render(results, Null(), 44100.0, gen)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t_render
    both = eng.render_all(results, [Null(), Microphone(shape=0.5)], gen,
                          output_sample_rate=44100.0)
    torch.cuda.synchronize()
    secs = {marks[i][0]: marks[i + 1][1] - marks[i][1]
            for i in range(len(marks) - 1)}
    trace_s = secs["running_raytracer"]
    depth = eng.optimum_depth(e.surfaces)
    steps = results.waveguide_bands[0].pressure.shape[0]
    print(f"[21 hybrid columns] {e.soup.num_triangles} triangles, mesh "
          f"{e.mesh.descriptor.dimensions} (the weight code phase 17 "
          f"checked), engine setup {setup:.2f} s; {params.rays} rays x "
          f"{depth} bounces")
    print(f"[21 hybrid columns] seconds: trace {trace_s:.3f}, image sources "
          f"{secs['finding_image_sources']:.3f}, waveguide "
          f"{secs['running_waveguide']:.3f} ({steps} steps), finish "
          f"{secs['finishing']:.3f}, render {t_render:.3f}; trace "
          f"{params.rays * depth / trace_s:.4e} ray-bounces/s; launches "
          f"{launches} [{card}]")
    ir_np = ir.cpu().numpy()
    finite = bool(np.all(np.isfinite(ir_np))) and \
        bool(torch.isfinite(both).all())
    arrival = float(np.linalg.norm(np.subtract(COLUMNS_SRC,
                                               COLUMNS_RCV))) / 340.0
    peak_t = float(np.abs(ir_np).argmax()) / 44100.0
    half = int(0.5 * 44100)
    early = float(np.square(ir_np[:half]).sum())
    late = float(np.square(ir_np[-half:]).sum())
    print(f"[21 hybrid columns] IR {ir_np.shape[0]} samples at 44.1 kHz, "
          f"finite {finite}; peak at {1e3 * peak_t:.2f} ms, direct arrival "
          f"{1e3 * arrival:.2f} ms (bound 20 ms); energy first 0.5 s "
          f"{early:.4e}, last 0.5 s {late:.4e}; render_all "
          f"{tuple(both.shape)}, max {float(both.abs().max()):.4f}")
    others = sum(v for k, v in launches.items() if k != "mesh_weighted_step")
    if not (finite and abs(peak_t - arrival) <= 0.02 and late < early
            and steps == COLUMNS_STEPS
            and launches["mesh_weighted_step"] == steps and others == 0
            and tuple(both.shape) == (2, ir_np.shape[0])):
        _fail("the hybrid columns hall failed its checks")
    return launches, {"setup_s": setup, "trace_s": trace_s,
                      "image_sources_s": secs["finding_image_sources"],
                      "waveguide_s": secs["running_waveguide"],
                      "render_s": t_render}


def phase_hybrid_columns_card_vs_cpu(torch, card):
    """The small columns hall (400 Hz cutoff) on the card and on the CPU,
    same draws, 2,048 rays and 0.1 s of waveguide: the waveguide band and
    the rendered IR."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    params = eng.RaytracerParameters(rays=1 << 11, max_time=1.5)
    outs, secs = [], []
    for device in ("cuda", "cpu"):
        _reset_mesh_counts()
        t0 = time.perf_counter()
        e = _columns_engine(torch, SMALL_COLUMNS_CUTOFF, device)
        results = e.run(COLUMNS_SRC, COLUMNS_RCV,
                        torch.Generator().manual_seed(SEED), params,
                        waveguide_time=0.1)
        ir = eng.render(results, Null(), 16000.0,
                        torch.Generator().manual_seed(SEED + 1))
        outs.append((results.waveguide_bands[0].pressure.cpu(), ir.cpu()))
        secs.append(time.perf_counter() - t0)
        n_b8 = _mesh_counts()["mesh_weighted_step"]
        if n_b8 != (outs[-1][0].shape[0] if device == "cuda" else 0):
            _fail(f"hybrid columns hall on {device}: {n_b8} B8 launches")
    (card_p, card_ir), (cpu_p, cpu_ir) = outs
    p_rel = float((card_p - cpu_p).abs().max()) / float(cpu_p.abs().max())
    ir_rel = float((card_ir - cpu_ir).abs().max()) \
        / float(cpu_ir.abs().max()) if card_ir.shape == cpu_ir.shape \
        else float("inf")
    print(f"[21 hybrid columns] small columns hall "
          f"{e.mesh.descriptor.dimensions}, {params.rays} rays, "
          f"{card_p.shape[0]} waveguide steps: card {secs[0]:.2f} s, CPU "
          f"{secs[1]:.2f} s; waveguide {p_rel:.3e} of peak (bound "
          f"{WAVEGUIDE_REL:g}), IR {tuple(card_ir.shape)} {ir_rel:.3e} of "
          f"peak (bound {HYBRID_REL:g}) [{card}]")
    if not (p_rel <= WAVEGUIDE_REL and ir_rel <= HYBRID_REL):
        _fail("the hybrid columns hall on the card differs from the CPU run")


def _general_grads(torch, mesh, src, rcv, steps, fs, timed=False):
    """Value and gradients of Σ taps² in (coef_b, coef_a, signal) through
    ``run_waveguide``, checkpointed every 16 steps."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, src, rcv, (steps - 0.5) / fs)
    structure, source, leaves = _leaves(mesh, source)
    sync = torch.cuda.synchronize if timed else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = wgrun.run_waveguide(structure, mesh.descriptor.dimensions, source,
                              _tap_receiver(receiver), n,
                              checkpoint_every=16)
    loss = torch.sum(out["outputs"] ** 2)
    sync()
    t1 = time.perf_counter()
    loss.backward()
    sync()
    t2 = time.perf_counter()
    return (float(loss.detach()), bool(out["stable"]),
            tuple(t.grad.detach() for t in leaves), t1 - t0, t2 - t1)


def _beside_column(mesh, nodes_off):
    """A position ``nodes_off`` nodes in +x from the first column's face
    (the column of ``procedural_hall``'s first draw: x 5.505 ± 0.4 m,
    z 8.969 m), at mid height."""
    dx = mesh.descriptor.spacing
    return (5.505 + 0.4 + nodes_off * dx, 4.0, 8.969)


def phase_general_gradient(torch, mesh, card):
    """The general gradient at full width: the columns hall, 64 steps."""
    steps = 64
    nodes = mesh.descriptor.num_nodes
    src, rcv = _beside_column(mesh, 3), _beside_column(mesh, 5)
    # warm-up through the checkpointed loop (32 > 16 steps): the first use
    # of torch.utils.checkpoint costs seconds of imports
    _general_grads(torch, mesh, src, rcv, 32, COLUMNS_FS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_mesh_counts()
    loss, stable, grads, t_fwd, t_bwd = _general_grads(
        torch, mesh, src, rcv, steps, COLUMNS_FS, timed=True)
    counts = _mesh_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    names = ("coef_b", "coef_a", "signal")
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = all(float(g.abs().max()) > 0 for g in grads)
    print(f"[22 general grad] {mesh.descriptor.dimensions}, {steps} steps, "
          f"checkpointed every 16, source 3 nodes from a column: loss "
          f"{loss:.6e}, stable {stable}, gradients finite {finite}, nonzero "
          f"{nonzero}; "
          + ", ".join(f"max |d/d{nm}| {float(g.abs().max()):.4e}"
                      for nm, g in zip(names, grads)))
    print(f"[22 general grad] launches {counts} (the forward runs twice "
          f"under checkpointing); forward {t_fwd:.4f} s "
          f"({1e3 * t_fwd / steps:.4f} ms/step), backward {t_bwd:.4f} s "
          f"({1e3 * t_bwd / steps:.4f} ms/step), "
          f"{nodes * steps / (t_fwd + t_bwd):.4e} node-updates/s "
          f"forward+backward, peak memory {peak_mem / 2**20:.1f} MiB "
          f"[{card}]")
    if not (stable and finite and nonzero
            and counts["mesh_weighted_step_bwd"] > 0
            and counts["mesh_weighted_step"] >= steps):
        _fail("the general gradient run failed its checks")
    prof = _profile_window(
        torch, "22 profile",
        lambda: _general_grads(torch, mesh, src, rcv, steps, COLUMNS_FS),
        steps, (t_fwd + t_bwd) / steps, card)
    b9 = tail = None
    if prof is not None:
        keys = [k for k in prof[3] if "mesh_weighted_step_bwd_kernel" in k]
        b9 = {"device_us": steps * sum(prof[3][k] for k in keys),
              "launches": sum(prof[4][k] for k in keys)}
        tail = _prev_cotangent_tail(torch, mesh.structure.weight_code,
                                    b9["launches"])
        print(f"[22 profile] B9 in the window's backward: "
              f"{b9['device_us']:.1f} us on the device in {b9['launches']} "
              f"launches ({b9['device_us'] / max(b9['launches'], 1):.2f} us "
              f"a launch); the eager -bit12*g cotangent of prev, profiled "
              f"alone {b9['launches']} times on the hall's code: "
              f"{tail['device_us_per_step']:.2f} us a step on the device in "
              f"{tail['kernels_per_step']:.1f} kernels [{card}]")
    return counts, {"steps": steps, "forward_s": t_fwd, "backward_s": t_bwd,
                    "peak_memory_bytes": peak_mem,
                    "profile": None if prof is None else {
                        "device_busy_us_per_step": prof[0],
                        "kernels_per_step": prof[1], "idle_share": prof[2],
                        "b9_backward": b9, "prev_cotangent_tail": tail}}


def _prev_cotangent_tail(torch, code, calls):
    """The backward's eager ĝprev = −bit12·g (``_prev_cotangent``) under
    the profiler, ``calls`` times on ``code`` and a random g: device µs and
    device kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    g = torch.randn(*code.shape, device="cuda")
    sk._prev_cotangent(g, code)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sk._prev_cotangent(g, code)
        torch.cuda.synchronize()
    us, kernels = _device_us(prof)
    return {"device_us_per_step": (us or 0.0) / max(calls, 1),
            "kernels_per_step": kernels / max(calls, 1)}


def phase_general_grad_card_vs_cpu(torch, card):
    """Gradients through the general path on the card against the plain
    versions on the CPU, on the small columns hall, 48 steps."""
    fs, _ = _columns_spacing(SMALL_COLUMNS_CUTOFF)
    results = {}
    for device in ("cuda", "cpu"):
        mesh = _columns_mesh(torch, SMALL_COLUMNS_CUTOFF, device)
        _reset_mesh_counts()
        t0 = time.perf_counter()
        _, stable, grads, _, _ = _general_grads(
            torch, mesh, _beside_column(mesh, 2), _beside_column(mesh, 4),
            48, fs)
        counts = _mesh_counts()
        if (counts["mesh_weighted_step_bwd"] > 0) != (device == "cuda") \
                or not stable:
            _fail(f"general gradient on {device}: launches {counts}, stable "
                  f"{stable}")
        results[device] = grads
        print(f"[22 general grad] small columns hall "
              f"{mesh.descriptor.dimensions}, 48 steps on {device}: "
              f"{time.perf_counter() - t0:.2f} s, launches {counts}")
    if not all(float(g.abs().max()) > 0 for g in results["cpu"]):
        _fail("a CPU gradient of the small columns hall is all zero")
    return _compare_grads("22 general grad", "general path on the card vs "
                          "plain versions on the CPU", results["cuda"],
                          results["cpu"])


# ---------------------------------------------------------------------------
# the ray acceleration: B3, B4, the voxel DDA, the scene loaders

def _ray_surfaces(torch, device):
    from wayverb_tpu_torch.core.surfaces import Surface
    return Surface(absorption=torch.full((1, 8), ABSORPTION, device=device),
                   scattering=torch.full((1, 8), 0.1, device=device))


def _ray_counts():
    from wayverb_tpu_torch.raytracer.mt_kernels import mt_closest
    return {"ray_mt_closest": mt_closest.launches,
            "ray_mt_closest_culled": mt_closest.culled_launches}


def _reset_ray_counts():
    from wayverb_tpu_torch.raytracer.mt_kernels import mt_closest
    mt_closest.launches = mt_closest.culled_launches = 0


def _triangles_soup(torch, num_triangles):
    """The first ``num_triangles`` triangles of a procedural hall (the
    kernels need no closed scene); 12 is the hall's bare shoebox, 3 the
    first three of its triangles."""
    import dataclasses
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    if num_triangles in (3, 12):
        box = box_scene(Box((0.0, 0.0, 0.0), (20.0, 8.0, 15.0)))
        return dataclasses.replace(
            box, triangles=box.triangles[:num_triangles],
            surfaces=box.surfaces[:num_triangles])
    args = {1000: (10, 0, 1), 5448: (20, 6, 3), 20000: (40, 10, 4)}
    soup, n = procedural_hall(*args[num_triangles])
    if n < num_triangles:
        _fail(f"procedural_hall{args[num_triangles]} has only {n} triangles")
    return dataclasses.replace(soup, triangles=soup.triangles[:num_triangles],
                               surfaces=soup.surfaces[:num_triangles])


def _random_rays(torch, n, gen, num_triangles=None, outside=False):
    """Rays from inside the 20 x 8 x 15 m hall (or from beyond it, heading
    away), with random excludes when given a triangle count."""
    size = torch.tensor([20.0, 8.0, 15.0], device="cuda")
    o = (0.05 + 0.9 * torch.rand(n, 3, generator=gen, device="cuda")) * size
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=gen, device="cuda"), dim=-1)
    if outside:
        o, d = o + 100.0, d.abs()
    ex = torch.full((n,), -1, dtype=torch.int32, device="cuda") \
        if num_triangles is None else torch.randint(
            -1, num_triangles, (n,), generator=gen, device="cuda",
            dtype=torch.int32)
    return o, d, ex


def _mt_compare(torch, tag, what, tris, got, want):
    """A launch's (t, id) against the plain version's on the same rays
    (``rays_timing.compare``); returns (max |t - t_plain|, share of rays
    that hit).  Equality to the bit is the gate."""
    from wayverb_tpu_torch.tools import rays_timing as rt
    try:
        return rt.compare(tag, what, tris, got, want,
                          log=functools.partial(print, flush=True))
    except rt.Mismatch as e:
        _fail(str(e))


def _mt_case(torch, tag, what, o, d, ex, tris):
    """``mt_closest`` (B3, or B4 for culled ``tris``) against its plain
    version on the same CUDA tensors, as the kernel takes them."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    o, d, ex, _ = mk._kernel_rays(o, d, ex, tris)
    got = mk.mt_closest(o, d, ex, tris)
    torch.cuda.synchronize()
    plain = mk._closest_culled_plain if tris.culled else mk._closest_plain
    return _mt_compare(torch, tag, what, tris, got, plain(o, d, ex, tris))


def _intersection_plain(torch, o, d, tris, exclude=None):
    """``mt_intersection`` with the plain version in the kernel's place."""
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    o, d, ex, order = mk._kernel_rays(o, d, exclude, tris)
    plain = mk._closest_culled_plain if tris.culled else mk._closest_plain
    t, idx = plain(o, d, ex, tris)
    if order is not None:
        t = torch.empty_like(t).index_copy_(0, order, t)
        idx = torch.empty_like(idx).index_copy_(0, order, idx)
        idx = tris.perm[torch.clamp(idx, 0, tris.perm.shape[0] - 1).long()]
    hit = t < mk.BIG
    return torch.where(hit, t, torch.full_like(t, float("inf"))), idx, hit


def phase_mt_vs_plain(torch, model_tris, large_tris, card):
    """B3 and B4 against their plain versions; returns their worst errors."""
    from wayverb_tpu_torch.core.geometry import TriangleSoup
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    worst = {False: 0.0, True: 0.0}
    for num_triangles, cull in ((3, False), (12, False), (1000, False),
                                (5448, False), (20000, False), (12, True),
                                (1000, True), (20000, True)):
        tris = mk.build_mt_triangles(_triangles_soup(torch, num_triangles),
                                     cull=cull).to("cuda")
        for rays in (100, 512, 700, 4096):
            for what in ("no excludes", "random excludes", "all miss"):
                o, d, ex = _random_rays(
                    torch, rays, gen,
                    num_triangles if what == "random excludes" else None,
                    outside=what == "all miss")
                err, hits = _mt_case(torch, "23 mt", what, o, d, ex, tris)
                worst[cull] = max(worst[cull], err)
                if (hits == 0.0) != (what == "all miss"):
                    _fail(f"{what}: {100 * hits:.1f}% of the rays hit")
    # equal t in two triangle tiles, and in other CTAs' shares of B3's
    # cluster: the lowest id wins, then, once it is excluded, the next copy,
    # unless a neighbour of the first copy (an edge shared at equal t) comes
    # first.  The premise holds only where the plain version meets it, and
    # the kernel must break it on exactly the rays where the plain version
    # does, since both queries equal the plain version to the bit.
    soup = _triangles_soup(torch, 1000)
    dup = TriangleSoup(soup.vertices, torch.cat([soup.triangles] * 3),
                       torch.cat([soup.surfaces] * 3))
    o, d, _ = _random_rays(torch, 4096, gen)
    for cull in (False, True):
        tris = mk.build_mt_triangles(dup, cull=cull).to("cuda")
        name = "B4" if cull else "B3"
        what = "a triangle list held three times (3000 triangles, equal t)"
        t, i, hit = mk.mt_intersection(o, d, tris)
        t1, i1, hit1 = mk.mt_intersection(o, d, tris, exclude_triangle=i)
        pt, pi, phit = _intersection_plain(torch, o, d, tris)
        pt1, pi1, phit1 = _intersection_plain(torch, o, d, tris, exclude=pi)
        same = all(torch.equal(x, y) for x, y in (
            (t, pt), (i, pi), (hit, phit), (t1, pt1), (i1, pi1),
            (hit1, phit1)))
        premise = hit & hit1 & (t1 == t) & (i1 == i + 1000)
        plain_premise = phit & phit1 & (pt1 == pt) & (pi1 == pi + 1000)
        broken = hit & ~premise
        neighbour = broken & hit1 & (t1 == t) & (i1 < 1000) & (i1 != i)
        ok = bool(hit.any()) and int(i[hit].max()) < 1000 and same \
            and torch.equal(premise, plain_premise) \
            and torch.equal(neighbour, broken) \
            and int(broken.sum()) <= int(hit.sum()) // 100
        print(f"[23 mt] {name} on {what}: of {int(hit.sum())} rays that hit, "
              f"the next copy wins once the first is excluded on "
              f"{int(premise.sum())} (plain version {int(plain_premise.sum())}"
              f"), an equal-t neighbour of the first copy on "
              f"{int(neighbour.sum())}, at rays "
              f"{torch.nonzero(broken).flatten().tolist()[:16]}; both "
              f"queries equal to the plain version to the bit: {same}; "
              f"lowest id wins: {ok}")
        if not ok:
            _fail("equal t did not resolve to the lowest triangle id")
        worst[cull] = max(worst[cull], _mt_case(
            torch, "23 mt", f"{what}, excludes from the first hit", o, d, i,
            tris)[0])
    # the tables the main paths use
    o, d, _ = _random_rays(torch, 4096, gen)
    _, first, _ = mk.mt_intersection(o, d, model_tris)
    worst[False] = max(worst[False], _mt_case(
        torch, "23 mt", "the model hall's own table, excludes from a first "
        "hit", o, d, first, model_tris)[0])
    _, first, _ = mk.mt_intersection(o, d, large_tris)
    worst[True] = max(worst[True], _mt_case(
        torch, "23 mt", "the large hall's own culled table, excludes from a "
        "first hit", o, d, first, large_tris)[0])
    # rays that have left the scene, as a trace's visibility query holds
    # them: every eighth origin NaN, every eighth infinite
    o = o.clone()
    o[0::8] = float("nan")
    o[1::8, 0] = float("inf")
    for cull, tris in ((False, model_tris), (True, large_tris)):
        worst[cull] = max(worst[cull], _mt_case(
            torch, "23 mt", "a quarter of the origins NaN or infinite", o, d,
            first, tris)[0])
    # B3's split: 1500 rays (a ragged second block; the 3 triangles above
    # are fewer than the cluster's shares), and rays aimed at the
    # barycentric slack's edges of the model hall's triangles, where the
    # skip tests are closest to dropping a hit
    tris = mk.build_mt_triangles(_triangles_soup(torch, 5448),
                                 cull=False).to("cuda")
    for what in ("no excludes", "random excludes"):
        o, d, ex = _random_rays(torch, 1500, gen,
                                5448 if what == "random excludes" else None)
        err, hits = _mt_case(torch, "23 mt", what, o, d, ex, tris)
        worst[False] = max(worst[False], err)
        if hits == 0.0:
            _fail(f"{what}: no ray hit 5448 triangles")
    from wayverb_tpu_torch.tools.rays_timing import edge_rays
    o, d = edge_rays(model_tris.packed[:, :model_tris.num], 4096,
                     np.random.default_rng(SEED + 20))
    err, hits = _mt_case(torch, "23 mt", "rays on the slack's edges", o, d,
                         None, model_tris)
    worst[False] = max(worst[False], err)
    if hits < 0.5:
        _fail(f"only {100 * hits:.1f}% of the slack-edge rays hit")
    return worst[False], worst[True]


def _recorded_queries(torch, soup, tris, src, rcv, keep):
    """The rays of a trace (65,536 rays from ``src``) exactly as ``mt_closest``
    gets them (``rays_timing.record_queries``): {number: (origin, direction,
    exclude)} for each query number in ``keep``, 2 * bounce for the closest
    hit and 2 * bounce + 1 for the receiver's visibility."""
    from wayverb_tpu_torch.tools import rays_timing as rt
    return rt.record_queries(soup, tris, src, rcv, keep, seed=SEED + 21,
                             num_rays=RAYS)


def mt_bounds(rays, tris, tile_pairs=None):
    """Bounds of one launch (``rays_timing.bound_us``).  Bytes: origin,
    direction, exclude in (28 B a ray), packed (and tile boxes) in, t and id
    out (8 B a ray).  B3's operations: 46 a (ray, real triangle) pair.  B4's:
    a slab test per (ray, triangle tile), and 46 a pair on the ``tile_pairs``
    (512-ray tile, 1024-triangle tile) pairs that the plain version's
    sequential gate lets through on these rays."""
    from wayverb_tpu_torch.tools import rays_timing as rt
    us, by = rt.bound_us(rays, tris, tile_pairs)
    return us / 1e3, by


def phase_mt_times(torch, model_soup, model_tris, large_soup, large_tris,
                   large_plain_tris, card):
    """B3 and B4 alone at 65,536 rays of the third bounce of their traces
    (CUDA events, the stream held while the host enqueues), and their plain
    versions (one run each, the gate's work counted per ray tile), whose
    results the kernels must equal to the bit at this, the main paths'
    shape; then the same on a later bounce's visibility query, dead rays
    among it (``rays_timing.kernel_case``, the ``--kernel`` mode of
    ``python -m wayverb_tpu_torch.tools.rays_timing``)."""
    from wayverb_tpu_torch.tools import rays_timing as rt
    out = {}
    cases = (
        ("b3", "model hall", model_soup, model_tris, COLUMNS_SRC,
         COLUMNS_RCV, 50, True),
        ("b4", "large hall", large_soup, large_tris, LARGE_SRC, LARGE_RCV,
         20, True),
        ("b3_large", "large hall, cull=False", large_soup, large_plain_tris,
         LARGE_SRC, LARGE_RCV, 5, True))
    for key, what, soup, tris, src, rcv, reps, plain in cases:
        try:
            row = rt.kernel_case(
                key, what, soup, tris, src, rcv, reps=reps, plain=plain,
                seed=SEED + 21, num_rays=RAYS, late_bounce=LATE_BOUNCE,
                tag="24 mt", card=card,
                log=functools.partial(print, flush=True))
        except rt.Mismatch as e:
            _fail(str(e))
        if plain and not (row["hits"] > 0.99 and row["dead"] > 0
                          and row["hits_late"] < 1.0):
            _fail(f"{what}: the recorded rays are not a trace's "
                  f"({100 * row['hits']:.2f}% hit at bounce 2; "
                  f"{row['dead']} dead rays at bounce {LATE_BOUNCE})")
        row["bound"] = mt_bounds(RAYS, tris, row.get("scanned_tile_pairs"))
        out[key] = row
    print(f"[24 mt] at the large hall the gate saves "
          f"{out['b3_large']['us'] / out['b4']['us']:.2f}x (B3 "
          f"{out['b3_large']['us']:.1f} us against B4 {out['b4']['us']:.1f} "
          f"us per launch, the ray sort not counted) [{card}]")
    for key in ("b3", "b4"):
        occ = out[key]["occupancy"]
        if occ["local_bytes"] or occ["registers"] > 64:
            _fail(f"{key.upper()} spills or exceeds 64 registers: {occ}")
    return out


def phase_model_hall(torch, model_soup, card):
    """The model hall as a user's room: save_obj -> load_scene -> Engine
    (no scene_box) -> run + render + render_all on the card."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core import scene as scene_io
    from wayverb_tpu_torch.core.attenuator import Microphone, Null
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer.accel import auto_accel
    from wayverb_tpu_torch.raytracer.mt_kernels import MtTriangles
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model_hall.obj")
        t0 = time.perf_counter()
        scene_io.save_obj(path, scene_io.SceneData(model_soup, ["default"]))
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        scene = scene_io.load_scene(path)
        t_load = time.perf_counter() - t0
    for f in ("vertices", "triangles", "surfaces"):
        if not torch.equal(getattr(scene.soup, f), getattr(model_soup, f)):
            _fail(f"the model hall's {f} changed on the way through the file")
    surfaces = scene.with_surfaces(Surface.uniform(ABSORPTION, 0.1))
    # the seconds of the mesh's setup stages, through compute_mesh's own
    # ``timings``, and of the ray tables, built once more here
    st = {}
    compute_mesh = eng.wgrun.compute_mesh
    eng.wgrun.compute_mesh = functools.partial(compute_mesh, timings=st)
    try:
        t0 = time.perf_counter()
        e = eng.Engine(scene.soup, surfaces,
                       eng.WaveguideParameters(cutoff=COLUMNS_CUTOFF,
                                               usable_portion=0.6),
                       device="cuda")
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
    finally:
        eng.wgrun.compute_mesh = compute_mesh
    t0 = time.perf_counter()
    auto_accel(scene.soup, "cuda")
    torch.cuda.synchronize()
    st["accel_s"] = time.perf_counter() - t0
    print(f"[25 model hall] {scene.soup.num_triangles} triangles through a "
          f"{size / 1e3:.0f} kB .obj (save {t_save:.2f} s, load "
          f"{t_load:.2f} s); mesh {e.mesh.descriptor.dimensions} = "
          f"{e.mesh.descriptor.num_nodes} nodes, "
          f"{e.mesh.structure.num_boundary_nodes} boundary; engine setup "
          f"{setup:.2f} s: classification {st['classify_s']:.2f} s by "
          f"{st['classifier']}, filter fit {st['fit_s']:.2f} s, structure "
          f"{st['structure_s']:.2f} s, ray tables {st['accel_s']:.3f} s")
    if not (isinstance(e.ray_grid, MtTriangles) and not e.ray_grid.culled
            and e.ray_grid.packed.is_cuda and e.mesh.box_spec is None
            and e.mesh.regions is None):
        _fail("the model hall did not get unculled MtTriangles on the card "
              "and a general mesh")
    params = eng.RaytracerParameters()
    depth = eng.optimum_depth(e.surfaces)
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    torch.cuda.reset_peak_memory_stats()
    _reset_mesh_counts()
    _reset_ray_counts()
    mark("start")
    results = e.run(COLUMNS_SRC, COLUMNS_RCV, gen, params,
                    waveguide_time=COLUMNS_STEPS / COLUMNS_FS,
                    state_callback=mark)
    mark("end")
    launches = {**_mesh_counts(), **_grad_counts(), **_ray_counts()}
    peak_mem = torch.cuda.max_memory_allocated()
    t_render = time.perf_counter()
    ir = eng.render(results, Null(), 44100.0, gen)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t_render
    both = eng.render_all(results, [Null(), Microphone(shape=0.5)], gen,
                          output_sample_rate=44100.0)
    torch.cuda.synchronize()
    secs = {marks[i][0]: marks[i + 1][1] - marks[i][1]
            for i in range(len(marks) - 1)}
    trace_s = secs["running_raytracer"]
    band = results.waveguide_bands[0]
    steps = band.pressure.shape[0]
    print(f"[25 model hall] {params.rays} rays x {depth} bounces, image-"
          f"source order {params.maximum_image_source_order}, "
          f"{results.image_source.count} image sources; seconds: trace "
          f"{trace_s:.3f}, image sources "
          f"{secs['finding_image_sources']:.3f}, waveguide "
          f"{secs['running_waveguide']:.3f} ({steps} steps), finish "
          f"{secs['finishing']:.3f}, render {t_render:.3f}; trace "
          f"{params.rays * depth / trace_s:.4e} ray-bounces/s; peak memory "
          f"{peak_mem / 2**20:.1f} MiB; launches {launches} [{card}]")
    ir_np = ir.cpu().numpy()
    finite = bool(np.all(np.isfinite(ir_np))) \
        and bool(torch.isfinite(both).all())
    stable = bool(torch.isfinite(band.pressure).all())
    arrival = float(np.linalg.norm(np.subtract(COLUMNS_SRC,
                                               COLUMNS_RCV))) / 340.0
    peak_t = float(np.abs(ir_np).argmax()) / 44100.0
    half = int(0.5 * 44100)
    early = float(np.square(ir_np[:half]).sum())
    late = float(np.square(ir_np[-half:]).sum())
    print(f"[25 model hall] IR {ir_np.shape[0]} samples at 44.1 kHz, finite "
          f"{finite}, waveguide stable {stable}; peak "
          f"{float(np.abs(ir_np).max()):.4e} at {1e3 * peak_t:.2f} ms, "
          f"direct arrival {1e3 * arrival:.2f} ms (bound 20 ms); energy "
          f"first 0.5 s {early:.4e}, last 0.5 s {late:.4e}; render_all "
          f"{tuple(both.shape)}, max {float(both.abs().max()):.4f}")
    others = sum(v for k, v in launches.items()
                 if k not in ("mesh_weighted_step", "ray_mt_closest"))
    if not (finite and stable and float(np.abs(ir_np).max()) > 0
            and abs(peak_t - arrival) <= 0.02 and late < early
            and steps == COLUMNS_STEPS
            and launches["mesh_weighted_step"] == steps
            and launches["ray_mt_closest"] == 2 * depth == 272
            and others == 0
            and tuple(both.shape) == (2, ir_np.shape[0])):
        _fail("the model hall failed its checks")
    return launches, {
        "triangles": scene.soup.num_triangles, "rays": params.rays,
        "bounces": depth, "setup_s": setup,
        **{k: v for k, v in st.items()}, "load_scene_s": t_load,
        "trace_s": trace_s, "ray_bounces_per_s": params.rays * depth / trace_s,
        "image_sources_s": secs["finding_image_sources"],
        "image_sources": results.image_source.count,
        "waveguide_s": secs["running_waveguide"], "render_s": t_render,
        "peak_memory_bytes": peak_mem}


def _timed_trace(torch, soup, accel, src, rcv, bounces, seed):
    from wayverb_tpu_torch.raytracer import tracer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tracer.trace(soup, _ray_surfaces(torch, "cuda"), src, rcv,
                       torch.Generator(device="cuda").manual_seed(seed),
                       num_rays=RAYS, depth=bounces, max_time=1.0,
                       accel=accel)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_large_hall(torch, large_soup, large_tris, large_plain_tris, card):
    """``trace`` on the 97 k-triangle hall with the culled kernel, then with
    cull=False: launches, energy, rates, and the first bounce's hits."""
    out = {}
    for key, tris in (("culled", large_tris), ("all pairs", large_plain_tris)):
        # one bounce first: the first argsort and scatter pay for themselves
        _timed_trace(torch, large_soup, tris, LARGE_SRC, LARGE_RCV, 1, SEED)
        _reset_ray_counts()
        res, dt = _timed_trace(torch, large_soup, tris, LARGE_SRC, LARGE_RCV,
                               LARGE_BOUNCES, SEED + 23)
        counts = _ray_counts()
        energy = float(res.histogram.sum())
        alive = float((res.triangle_history[-1] >= 0).float().mean())
        print(f"[26 large hall] {tris.num} triangles, {RAYS} rays x "
              f"{LARGE_BOUNCES} bounces, {key}: {dt:.3f} s, "
              f"{RAYS * LARGE_BOUNCES / dt:.4e} ray-bounces/s; deposited "
              f"energy {energy:.6e}, {100 * alive:.2f}% of rays alive at the "
              f"end; launches {counts} [{card}]")
        want = {"ray_mt_closest": 0, "ray_mt_closest_culled": 0}
        want["ray_mt_closest_culled" if tris.culled else "ray_mt_closest"] = \
            2 * LARGE_BOUNCES
        if not (counts == want and math.isfinite(energy) and energy > 0
                and alive > 0.99):
            _fail(f"the large hall's trace ({key}) failed its checks")
        out[key] = (res, dt, counts)
    # Among exactly equal t the lowest id wins, and the culled kernel's ids
    # are Morton-sorted: a ray through a shared edge may take the other of
    # two coplanar triangles.  Such hits must lie in one plane.
    from wayverb_tpu_torch.core.geometry import triangle_normals
    first = [out[k][0].triangle_history[0].long() for k in out]
    differ = first[0] != first[1]
    same = 1.0 - float(differ.float().mean())
    normals = triangle_normals(large_soup)
    coplanar = bool(torch.allclose(normals[first[0][differ]],
                                   normals[first[1][differ]], atol=1e-6))
    e0, e1 = (float(out[k][0].histogram.sum()) for k in out)
    print(f"[26 large hall] first bounce: {int(differ.sum())} of {RAYS} hit "
          f"triangles differ between the culled and the all-pairs kernel "
          f"(bound {100 * (1 - MT_T_SHARE):.1f}%), every one a tie between "
          f"coplanar triangles: {coplanar}; deposited energy differs by "
          f"{abs(e0 - e1) / e1:.3e} of it (bound 1e-4); the culled trace is "
          f"{out['all pairs'][1] / out['culled'][1]:.2f}x faster [{card}]")
    if not (same >= MT_T_SHARE and coplanar and abs(e0 - e1) <= 1e-4 * e1):
        _fail("culled and all-pairs kernels disagree on the first bounce")
    return out["culled"][2], {
        "triangles": large_tris.num, "rays": RAYS, "bounces": LARGE_BOUNCES,
        "culled_s": out["culled"][1], "all_pairs_s": out["all pairs"][1],
        "culled_ray_bounces_per_s": RAYS * LARGE_BOUNCES / out["culled"][1],
        "all_pairs_ray_bounces_per_s":
            RAYS * LARGE_BOUNCES / out["all pairs"][1]}


def phase_dda_on_card(torch, model_soup, model_tris, card):
    """The voxel DDA on the card on the model hall: its rate beside B3's,
    and one bounce's closest hits against B3's."""
    from wayverb_tpu_torch.raytracer import accel as ray_accel
    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    t0 = time.perf_counter()
    grid = ray_accel.build_ray_grid(model_soup).to("cuda")
    t_build = time.perf_counter() - t0
    _timed_trace(torch, model_soup, grid, COLUMNS_SRC, COLUMNS_RCV, 1, SEED)
    _reset_ray_counts()
    res, dt = _timed_trace(torch, model_soup, grid, COLUMNS_SRC, COLUMNS_RCV,
                           LARGE_BOUNCES, SEED + 24)
    if any(_ray_counts().values()):
        _fail("the DDA trace launched an MT kernel")
    res_mt, dt_mt = _timed_trace(torch, model_soup, model_tris, COLUMNS_SRC,
                                 COLUMNS_RCV, LARGE_BOUNCES, SEED + 24)
    agree = float((res.triangle_history
                   == res_mt.triangle_history).float().mean())
    e_dda, e_mt = float(res.histogram.sum()), float(res_mt.histogram.sum())
    print(f"[27 dda] model hall, grid {grid.res}, at most "
          f"{grid.max_per_cell} triangles a cell (built in {t_build:.2f} s "
          f"on the host); {RAYS} rays x {LARGE_BOUNCES} bounces: DDA "
          f"{dt:.3f} s = {RAYS * LARGE_BOUNCES / dt:.4e} ray-bounces/s, B3 "
          f"{dt_mt:.3f} s = {RAYS * LARGE_BOUNCES / dt_mt:.4e} (same draws; "
          f"{100 * agree:.3f}% of the hit history equal, deposited energy "
          f"{e_dda:.6e} vs {e_mt:.6e}) [{card}]")
    # unculled tables: the kernel's rays are the tracer's, ids the soup's
    o, d, ex = _recorded_queries(torch, model_soup, model_tris, COLUMNS_SRC,
                                 COLUMNS_RCV, {4})[4]
    tg, ig, hg = ray_accel.grid_intersection(o, d, grid, model_soup, ex)
    tm, im, hm = mk.mt_intersection(o, d, model_tris, ex)
    hits_equal = float((hg == hm).float().mean())
    both = hg & hm
    rel = (tg[both] - tm[both]).abs() / tm[both]
    within = float((rel <= MT_T_RTOL).float().mean())
    ids = float((ig[both] == im[both]).float().mean())
    print(f"[27 dda] closest hits of bounce 2, DDA against B3: hit masks "
          f"equal on {100 * hits_equal:.4f}% of rays (bound "
          f"{100 * MT_T_SHARE:g}%), relative |Δt| <= {MT_T_RTOL:g} on "
          f"{100 * within:.4f}% (bound {100 * MT_T_SHARE:g}%; max "
          f"{float(rel.max()):.3e}), {100 * ids:.3f}% of ids equal (bound "
          f"{100 * MT_ID_SHARE:g}%)")
    if not (hits_equal >= MT_T_SHARE and within >= MT_T_SHARE
            and ids >= MT_ID_SHARE and e_dda > 0
            and abs(e_dda - e_mt) <= 1e-2 * e_mt):
        _fail("the DDA on the card disagrees with B3")
    return {"grid_res": list(grid.res), "max_per_cell": grid.max_per_cell,
            "dda_s": dt, "dda_ray_bounces_per_s": RAYS * LARGE_BOUNCES / dt,
            "b3_s": dt_mt,
            "b3_ray_bounces_per_s": RAYS * LARGE_BOUNCES / dt_mt}


def phase_hall_card_vs_cpu(torch, card):
    """A hall of 132 triangles (above the dense limit) through Engine.run +
    render: the MT kernel on the card against the DDA on the CPU, same
    draws (2,048 rays, absorption 0.2 for 64 bounces, not 136: the DDA on
    the CPU takes most of the phase)."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    params = eng.RaytracerParameters(rays=1 << 11, max_time=1.5)
    surfaces = Surface(absorption=torch.full((1, 8), 0.2),
                       scattering=torch.full((1, 8), 0.1))
    soup, n_tri = procedural_hall(3, 2, 1)
    outs, secs, backends = [], [], []
    for device in ("cuda", "cpu"):
        _reset_mesh_counts()
        _reset_ray_counts()
        t0 = time.perf_counter()
        e = eng.Engine(soup, surfaces,
                       eng.WaveguideParameters(cutoff=SMALL_COLUMNS_CUTOFF,
                                               usable_portion=0.6),
                       device=device)
        results = e.run(COLUMNS_SRC, COLUMNS_RCV,
                        torch.Generator().manual_seed(SEED), params,
                        waveguide_time=0.25)
        ir = eng.render(results, Null(), 16000.0,
                        torch.Generator().manual_seed(SEED + 1))
        outs.append((results.waveguide_bands[0].pressure.cpu(), ir.cpu(),
                     results.image_source.count))
        secs.append(time.perf_counter() - t0)
        backends.append(type(e.ray_grid).__name__)
        n_b3 = _ray_counts()["ray_mt_closest"]
        depth = eng.optimum_depth(e.surfaces)
        if n_b3 != (2 * depth if device == "cuda" else 0):
            _fail(f"small hall on {device}: {n_b3} B3 launches")
    (card_p, card_ir, card_n), (cpu_p, cpu_ir, cpu_n) = outs
    p_rel = float((card_p - cpu_p).abs().max()) / float(cpu_p.abs().max())
    ir_rel = float((card_ir - cpu_ir).abs().max()) \
        / float(cpu_ir.abs().max()) if card_ir.shape == cpu_ir.shape \
        else float("inf")
    print(f"[28 card vs cpu] hall of {n_tri} triangles, "
          f"{e.mesh.descriptor.dimensions}, {params.rays} rays: card "
          f"({backends[0]}) {secs[0]:.2f} s, CPU ({backends[1]}) "
          f"{secs[1]:.2f} s; image sources {card_n} vs {cpu_n}; waveguide "
          f"{p_rel:.3e} of peak (bound {WAVEGUIDE_REL:g}), IR "
          f"{tuple(card_ir.shape)} {ir_rel:.3e} of peak (bound "
          f"{HYBRID_REL:g}) [{card}]")
    if not (backends == ["MtTriangles", "RayGrid"] and card_n == cpu_n
            and p_rel <= WAVEGUIDE_REL and ir_rel <= HYBRID_REL):
        _fail("the hall on the card differs from the CPU run")
    return ir_rel


# ---------------------------------------------------------------------------
# the sharded waveguide: B10, B11, parallel/ on x-shards of one card

SHARDS = 4
SHARD_DEVICES = ["cuda:0"] * SHARDS
SHARDED_GENERAL_REL = 5e-5  # tests/test_general_sharded.py:62-63, of peak
ENGINE_SHARDED_REL = 1e-5   # sharded vs single-device engine IR, of peak
BOX_SHARDED_REL = 1e-5      # sharded vs single fused shoebox, of peak
BOX_SHARDED_STEPS = 128
F64_STATE_STEPS = 32        # the float64-state sharded shoebox (phase 33)


def _shard_counts():
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    return {"mesh_weighted_step_haloed": sk.weighted_step_sharded.launches,
            "mesh_weighted_step_haloed_bwd":
                sk.weighted_step_sharded_bwd.launches}


def _reset_shard_counts():
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    sk.weighted_step_sharded.launches = 0
    sk.weighted_step_sharded_bwd.launches = 0
    _reset_mesh_counts()


def _device_mesh():
    from wayverb_tpu_torch.parallel.sharding import make_device_mesh
    return make_device_mesh(SHARDS, devices=SHARD_DEVICES)


def _sharded_columns_engine(torch, card):
    """``Engine(device_mesh=…)`` on the columns hall at 1500 Hz: its mesh,
    x aligned to the shard count, also serves phases 30 and 31."""
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer.scenes import procedural_hall
    surfaces = Surface(absorption=torch.full((1, 8), ABSORPTION),
                       scattering=torch.full((1, 8), 0.1))
    t0 = time.perf_counter()
    e = eng.Engine(procedural_hall(2, 4, 1)[0], surfaces,
                   eng.WaveguideParameters(cutoff=COLUMNS_CUTOFF,
                                           usable_portion=0.6),
                   device_mesh=_device_mesh(), device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    dims = e.mesh.descriptor.dimensions
    print(f"[29 sharded] Engine(device_mesh={SHARDS} x cuda:0) on the "
          f"columns hall: mesh {dims} (x aligned to {SHARDS}), setup "
          f"{setup:.2f} s; shards of {(dims[0] // SHARDS,) + dims[1:]} "
          f"[{card}]")
    if dims[0] % SHARDS or e.mesh.box_spec is not None:
        _fail("the sharded engine's mesh is not a general mesh whose x "
              "divides over the shards")
    return e, setup


def _device_time_us(torch, fn, reps):
    """(device µs of one ``fn()``, host µs of one call), the stream held
    while the host enqueues (``mega_timing.device_time_us``)."""
    from wayverb_tpu_torch.tools.mega_timing import device_time_us
    return device_time_us(fn, reps)


def shard_kernel_bounds(xl, Y, Z):
    """(bound_ms, bound_by) per launch of B10 and B11 at a shard of (xl, Y,
    Z), from ``mesh_timing.shard_bounds``: B10 reads B8's cur, prev and
    int32 code plus the two halo rows and writes out, 15 operations a node;
    B11 reads B9's g and code and writes gcur plus the two halo rows, 13
    operations a node and two multiplies per halo element."""
    from wayverb_tpu_torch.tools.mesh_timing import shard_bounds
    return {k: (us / 1e3, by)
            for k, (us, by) in shard_bounds((xl, Y, Z)).items()}


def phase_shard_kernels(torch, structure, card):
    """B10 and B11 against their plain versions on the card, random inputs
    with non-zero halos: the columns hall's shard shape, one and two rows,
    odd (Y, Z), and a shard of the hall's own weight code; both to the bit
    (``mesh_timing.bits_equal``), B10 into a fresh output and into
    ``out=prev``, and on the hall's shard code also at 1e38 with ±inf and
    NaN, all −0, and its slices of Y·Z < 32 and of one and two rows; then
    their times at the shard shape, and the registers, local bytes, CTAs
    an SM and share of warps on the bare path of each."""
    from wayverb_tpu_torch.tools.mesh_timing import (b10_equal, b10_inputs,
                                                     bare_warps, bits_equal,
                                                     case_g,
                                                     forward_bare_warps)
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    X, Y, Z = structure.weight_code.shape
    xl = X // SHARDS
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device="cuda")
    hall = structure.weight_code[xl:2 * xl].contiguous()
    worst = [0.0, 0.0]
    cases = [((xl, Y, Z), "the columns hall's shard shape"),
             ((1, Y, Z), "one row"), ((2, Y, Z), "two rows"),
             ((5, 37, 53), "odd (Y, Z)"), ((1, 7, 9), "one row, odd (Y, Z)"),
             ((3, 2, 300), "a ragged z block")]
    for dims, what in cases + [((xl, Y, Z), "a shard of the hall's own "
                                "weight code")]:
        if what.startswith("a shard"):
            code = hall
        else:
            code = torch.randint(0, 1 << 13, dims, generator=gen,
                                 device="cuda", dtype=torch.int32)
        cur, prev, g = rnd(*dims), rnd(*dims), rnd(*dims)
        halos = (rnd(1, *dims[1:]), rnd(1, *dims[1:]))
        alias = prev.clone()
        fwd = sk.weighted_step_sharded(cur, prev, code, halos)
        sk.weighted_step_sharded(cur, alias, code, halos, out=alias)
        want = sk._weighted_step_sharded_plain(cur, prev, code, halos)
        gk, (hk0, hk1) = sk.weighted_step_sharded_bwd(g, code)
        gp, (hp0, hp1) = sk._weighted_step_sharded_bwd_plain(g, code)
        torch.cuda.synchronize()
        pairs = (("B10", [(fwd, want), (alias, want)]),
                 ("B11", [(gk, gp), (hk0, hp0), (hk1, hp1)]))
        for i, (name, outs) in enumerate(pairs):
            err = max(float((a - b).abs().max()) for a, b in outs)
            peak = max(float(b.abs().max()) for _, b in outs)
            worst[i] = max(worst[i], err)
            equal = all(bits_equal(a, b) for a, b in outs)
            print(f"[29 sharded] {name} {dims} ({what}): max |kernel - "
                  f"plain| = {err:.3e}, peak {peak:.3e}: bit-equal {equal}"
                  f"{' (fresh and out=prev)' if i == 0 else ''}")
            if not (equal and peak > 0):
                _fail(f"{name} differs from its plain version: {what}")

    more = [(hall, "1e38 inf nan",
             "the hall's shard code, inputs at 1e38 with inf and NaN"),
            (hall, "all -0", "the hall's shard code, inputs all -0"),
            (hall[:4, 60:63, 100:105].contiguous(), "random",
             "a slice of it with Y*Z < 32"),
            (hall[40:41].contiguous(), "random", "one row of it"),
            (hall[40:42].contiguous(), "random", "two rows of it")]
    for code, kind, what in more:
        dims = tuple(code.shape)
        g = case_g(kind, dims, gen)
        got = sk.weighted_step_sharded_bwd(g, code)
        want = sk._weighted_step_sharded_bwd_plain(g, code)
        torch.cuda.synchronize()
        equal = all(bits_equal(a, b) for a, b in zip(
            (got[0], *got[1]), (want[0], *want[1])))
        print(f"[29 sharded] B11 {dims} ({what}): bit-equal {equal}")
        if not equal:
            _fail(f"B11 differs from its plain version: {what}")
        cur, prev, halos = b10_inputs(kind, dims, gen)
        check = b10_equal(cur, prev, code, halos)
        print(f"[29 sharded] B10 {dims} ({what}): bit-equal "
              f"{check['equal']}, into out=prev {check['equal_out_prev']}")
        if not (check["equal"] and check["equal_out_prev"]):
            _fail(f"B10 differs from its plain version: {what}")

    dims = (xl, Y, Z)
    code = hall
    cur, prev, g = rnd(*dims), rnd(*dims), rnd(*dims)
    halos = (rnd(1, Y, Z), rnd(1, Y, Z))
    out = torch.empty_like(cur)
    bounds = shard_kernel_bounds(xl, Y, Z)
    times = {}
    for name, kernel, plain in (
            ("b10", lambda: sk.weighted_step_sharded(cur, prev, code, halos,
                                                     out=out),
             lambda: sk._weighted_step_sharded_plain(cur, prev, code, halos)),
            ("b11", lambda: sk.weighted_step_sharded_bwd(g, code),
             lambda: sk._weighted_step_sharded_bwd_plain(g, code))):
        k_us, k_host = _device_time_us(torch, kernel, 200)
        p_us, _ = _device_time_us(torch, plain, 20)
        times[name] = (k_us, p_us)
        print(f"[29 sharded] {name.upper()} alone at {dims} = "
              f"{xl * Y * Z} nodes: kernel {k_us:.2f} us/launch on the "
              f"device ({k_host:.2f} us a call on the host), plain version "
              f"{p_us:.2f} us, bound {1e3 * bounds[name][0]:.2f} us by "
              f"{bounds[name][1]} [{card}]")
    occ = {"b10": sk.shard_fwd_occupancy(dims=dims),
           "b11": sk.shard_bwd_occupancy(dims=dims)}
    share = {"b10": float(forward_bare_warps(
                 code, occ["b10"]["threads"]).float().mean()),
             "b11": float(bare_warps(code).float().mean())}
    for name in ("b10", "b11"):
        o = occ[name]
        print(f"[29 sharded] {name.upper()}: {share[name]:.4f} of its warps "
              f"on the hall's shard code take the bare path; "
              f"{o['registers']} registers, {o['local_bytes']} B local, "
              f"{o['ctas_per_sm']} CTAs of {o['threads']} an SM, "
              f"{o['grid']} CTAs a launch; {times[name][0]:.2f} us = "
              f"{times[name][0] / (1e3 * bounds[name][0]):.3f} x its bound "
              f"[{card}]")
        if o["local_bytes"]:
            _fail(f"{name.upper()} spills to local memory")
    print(json.dumps({"phase": "29 sharded kernels", "shape": list(dims),
                      "max_abs_err": {"b10": worst[0], "b11": worst[1]},
                      "ms": {k: v[0] / 1e3 for k, v in times.items()},
                      "plain_ms": {k: v[1] / 1e3 for k, v in times.items()},
                      "bound_ms": {k: v[0] for k, v in bounds.items()},
                      "time_over_bound": {
                          k: times[k][0] / (1e3 * bounds[k][0])
                          for k in times},
                      "bare_warp_share": share, "occupancy": occ}))
    return worst, times, bounds, {k: {**occ[k], "bare_warp_share": share[k]}
                                  for k in occ}


def phase_general_sharded(torch, mesh, card):
    """The columns hall on 4 shards of one card, 1000 steps, against the
    single-device B8 run on the same mesh."""
    from wayverb_tpu_torch.parallel import general_sharded as gs
    from wayverb_tpu_torch.waveguide import run as wgrun
    steps = COLUMNS_STEPS
    dims = mesh.descriptor.dimensions
    nodes = mesh.descriptor.num_nodes
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, COLUMNS_SRC, COLUMNS_RCV, (steps - 0.5) / COLUMNS_FS)
    devmesh = _device_mesh()
    run = lambda k: gs.run_waveguide_general_sharded(  # noqa: E731
        devmesh, mesh.structure, dims, source, receiver, k)
    run(min(16, n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_shard_counts()
    t0 = time.perf_counter()
    out = run(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**_shard_counts(), **_mesh_counts()}
    peak_mem = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ref = wgrun.run_waveguide(mesh.structure, dims, source, receiver, n)
    torch.cuda.synchronize()
    wall_single = time.perf_counter() - t0
    (ia, pa), (ib, pb) = out["outputs"], ref["outputs"]
    peak = float(pb.abs().max())
    err = max(float((pa - pb).abs().max()), float((ia - ib).abs().max()))
    stable = bool(out["stable"])
    print(f"[30 sharded general] {dims} on {SHARDS} x cuda:0, {n} steps: "
          f"stable {stable}, launches {counts}; against the single-device "
          f"B8 run: max |Δ| {err:.3e}, peak |p| {peak:.4f} (bound "
          f"{SHARDED_GENERAL_REL:g} x peak)")
    print(f"[30 sharded general] sharded wall {1e3 * wall / n:.4f} ms/step "
          f"({nodes * n / wall:.4e} node-updates/s), single-device "
          f"{1e3 * wall_single / n:.4f} ms/step; peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    if not (stable and bool(ref["stable"]) and peak > 0
            and err <= SHARDED_GENERAL_REL * peak
            and counts["mesh_weighted_step_haloed"] == SHARDS * n
            and counts["mesh_weighted_step"] == 0):
        _fail("the sharded general run failed its checks")
    prof = _profile_window(torch, "30 profile", lambda: run(min(32, n)),
                           min(32, n), wall / n, card)
    b10_us = None
    if prof is not None:
        b10_us = sum(t for key, t in prof[3].items()
                     if "mesh_weighted_step_haloed_kernel" in key)
        print(f"[30 profile] of the unprofiled {1e6 * wall / n:.1f} us/step: "
              f"B10 {b10_us:.1f} us ({SHARDS} launches), the rest of the "
              f"device {prof[0] - b10_us:.1f} us, device idle "
              f"{1e6 * wall / n - prof[0]:.1f} us [{card}]")
    result = {"dims": list(dims), "shards": SHARDS, "steps": n,
              "wall_ms_per_step": 1e3 * wall / n,
              "single_device_wall_ms_per_step": 1e3 * wall_single / n,
              "max_abs_err_vs_single": err, "peak_memory_bytes": peak_mem,
              "launches": counts,
              "profile": None if prof is None else {
                  "device_busy_us_per_step": prof[0],
                  "b10_us_per_step": b10_us,
                  "kernels_per_step": prof[1], "idle_share": prof[2]}}
    print(json.dumps({"phase": "30 sharded general", **result}))
    return result


def _device_us(prof, match=""):
    """Device µs and launches of the profiled kernels whose name holds
    ``match`` (all with ""); (None, 0) when the profiler saw no device
    time."""
    us, launches = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and match in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total",
                                                  0.0)
            launches += e.count
    return (us if us > 0 else None), launches


def _profiled_gradient(torch, run, mesh):
    """One more sharded gradient (``run(structure)``), its forward and its
    backward each under torch.profiler: their walls with the profiler on,
    the device µs of every kernel in each, and B11's device µs and
    launches in the backward (device times None when the profiler saw no
    device time)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    coef_b = mesh.structure.coef_b.detach().clone().requires_grad_(True)
    structure = dataclasses.replace(mesh.structure, coef_b=coef_b)
    out = {}
    torch.cuda.synchronize()
    for part in ("forward", "backward"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "forward":
                loss = torch.sum(run(structure)["outputs"] ** 2)
            else:
                loss.backward()
            torch.cuda.synchronize()
            out[f"{part}_s"] = time.perf_counter() - t0
        out[f"{part}_device_us"] = _device_us(prof)[0]
    out["b11_device_us"], out["b11_launches"] = _device_us(prof, "haloed_bwd")
    return out


def phase_general_sharded_gradient(torch, mesh, card):
    """d(Σ taps²)/d coef_b through 4 shards, 32 steps, the source 3 nodes
    from a column, against the single-device gradient on the same mesh."""
    import dataclasses
    from wayverb_tpu_torch.parallel import general_sharded as gs
    from wayverb_tpu_torch.waveguide import run as wgrun
    steps = 32
    dims = mesh.descriptor.dimensions
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, _beside_column(mesh, 3), _beside_column(mesh, 5),
        (steps - 0.5) / COLUMNS_FS)
    receiver = _tap_receiver(receiver)
    devmesh = _device_mesh()

    def grads(run):
        coef_b = mesh.structure.coef_b.detach().clone().requires_grad_(True)
        structure = dataclasses.replace(mesh.structure, coef_b=coef_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = torch.sum(run(structure)["outputs"] ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return coef_b.grad, t1 - t0, time.perf_counter() - t1

    sharded = lambda s: gs.run_waveguide_general_sharded(  # noqa: E731
        devmesh, s, dims, source, receiver, n)
    grads(lambda s: gs.run_waveguide_general_sharded(
        devmesh, s, dims, source, receiver, 8))
    torch.cuda.reset_peak_memory_stats()
    _reset_shard_counts()
    g_sh, t_fwd, t_bwd = grads(sharded)
    counts = {**_shard_counts(), **_mesh_counts()}
    peak_mem = torch.cuda.max_memory_allocated()
    g_si, t_fwd1, t_bwd1 = grads(lambda s: wgrun.run_waveguide(
        s, dims, source, receiver, n))
    scale = float(g_si.abs().max())
    err = float((g_sh - g_si).abs().max())
    ok_elem = bool(((g_sh - g_si).abs()
                    <= 1e-7 + 1e-4 * g_si.abs()).all())
    print(f"[31 sharded grad] {dims} on {SHARDS} x cuda:0, {n} steps, "
          f"source 3 nodes from a column: max |Δ d/dcoef_b| {err:.3e} = "
          f"{err / scale:.3e} of the largest component {scale:.4e}; within "
          f"rtol 1e-4, atol 1e-7: {ok_elem}; launches {counts}")
    print(f"[31 sharded grad] forward {t_fwd:.4f} s, backward {t_bwd:.4f} s "
          f"(single device {t_fwd1:.4f} s, {t_bwd1:.4f} s); peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    if not (scale > 0 and ok_elem
            and 0 < counts["mesh_weighted_step_haloed_bwd"]
            <= SHARDS * (n - 1)
            and counts["mesh_weighted_step_haloed"] == SHARDS * n):
        _fail("the sharded general gradient failed its checks")
    prof = _profiled_gradient(torch, sharded, mesh)
    b11_us, b11_n = prof["b11_device_us"], prof["b11_launches"]
    if b11_us is None:
        print("[31 sharded grad] B11's device time not measured: the "
              "profiler saw no device activity")
    else:
        print(f"[31 sharded grad] one more gradient under the profiler: "
              f"forward {prof['forward_s']:.4f} s with "
              f"{prof['forward_device_us']:.1f} us on the device, backward "
              f"{prof['backward_s']:.4f} s with "
              f"{prof['backward_device_us']:.1f} us on the device, of which "
              f"B11 {b11_us:.1f} us in {b11_n} launches "
              f"({b11_us / max(b11_n, 1):.2f} us a launch); walls with the "
              f"profiler on (unprofiled "
              f"{t_fwd:.4f} s, {t_bwd:.4f} s) [{card}]")
    result = {"steps": n, "forward_s": t_fwd, "backward_s": t_bwd,
              "single_device_forward_s": t_fwd1,
              "single_device_backward_s": t_bwd1,
              "max_rel_err_vs_single": err / scale,
              "peak_memory_bytes": peak_mem, "launches": counts,
              "b11_device_us": b11_us, "b11_profiled_launches": b11_n,
              "profiled": prof}
    print(json.dumps({"phase": "31 sharded gradient", **result}))
    return counts, result


def phase_sharded_engine(torch, e, setup_s, card):
    """``Engine(device_mesh=…)`` run + render on the columns hall against a
    single-device engine on the same mesh (a copy of the engine without
    its device mesh), same draws."""
    import copy
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    single = copy.copy(e)
    single.device_mesh = None
    params = eng.RaytracerParameters()
    steps = SHARDED_ENGINE_STEPS
    results, secs, launches, irs = [], [], [], []
    for engine in (e, single):
        marks = []

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        _reset_shard_counts()
        mark("start")
        res = engine.run(COLUMNS_SRC, COLUMNS_RCV,
                         torch.Generator().manual_seed(SEED + 31), params,
                         waveguide_time=steps / COLUMNS_FS,
                         state_callback=mark)
        mark("end")
        launches.append({**_shard_counts(), **_mesh_counts()})
        t0 = time.perf_counter()
        irs.append(eng.render(res, Null(), 44100.0,
                              torch.Generator().manual_seed(SEED + 32)))
        torch.cuda.synchronize()
        s = {marks[i][0]: marks[i + 1][1] - marks[i][1]
             for i in range(len(marks) - 1)}
        s["render"] = time.perf_counter() - t0
        secs.append(s)
        results.append(res)
    ir1, ir0 = irs
    peak = float(ir0.abs().max())
    err = float((ir1 - ir0).abs().max()) if ir1.shape == ir0.shape \
        else float("inf")
    p1, p0 = (r.waveguide_bands[0].pressure for r in results)
    p_err = float((p1 - p0).abs().max())
    for tag, s, n in (("sharded", secs[0], launches[0]),
                      ("single", secs[1], launches[1])):
        print(f"[32 sharded engine] {tag}: trace "
              f"{s['running_raytracer']:.3f} s, image sources "
              f"{s['finding_image_sources']:.3f} s, waveguide "
              f"{s['running_waveguide']:.3f} s, finish {s['finishing']:.3f} "
              f"s, render {s['render']:.3f} s; launches {n} [{card}]")
    print(f"[32 sharded engine] setup {setup_s:.2f} s; IR "
          f"{tuple(ir1.shape)}: sharded vs single-device max |Δ| "
          f"{err:.3e} = {err / peak:.3e} of peak (bound "
          f"{ENGINE_SHARDED_REL:g}); waveguide band max |Δp| {p_err:.3e}")
    if not (err <= ENGINE_SHARDED_REL * peak and peak > 0
            and bool(torch.isfinite(ir1).all())
            and launches[0]["mesh_weighted_step_haloed"] == SHARDS * steps
            and launches[0]["mesh_weighted_step"] == 0
            and launches[1]["mesh_weighted_step"] == steps
            and launches[1]["mesh_weighted_step_haloed"] == 0):
        _fail("the sharded engine failed its checks")
    result = {"setup_s": setup_s, "sharded": secs[0],
              "single_device": secs[1], "ir_rel_err": err / peak,
              "launches": launches[0]}
    print(json.dumps({"phase": "32 sharded engine", **result}))
    return launches[0], result, (p1, ir1)


def phase_box_sharded(torch, card):
    """The shoebox hall (224, 224, 256) on 4 shards of one card: 128 steps
    against the single-device fused run (both inject before the step),
    then a 16-step coef_b gradient beside a wall and a shard boundary."""
    import dataclasses
    from wayverb_tpu_torch.parallel import box_sharded as bsh
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import (fused_step,
                                                       fused_step_bwd)
    box, dx, mesh, setup_s = _hall_mesh(torch)
    spec, desc = mesh.box_spec, mesh.descriptor
    if spec.dims[0] % SHARDS:
        _fail(f"the shoebox hall's x {spec.dims[0]} does not divide over "
              f"{SHARDS} shards")
    devmesh = _device_mesh()
    steps = BOX_SHARDED_STEPS
    src, rcv = _hall_positions(box, dx)
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, src, rcv, _hall_sim_time(mesh, steps))
    bsh.run_waveguide_box_sharded(devmesh, mesh.structure, spec, source,
                                  receiver, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_grad_counts()
    t0 = time.perf_counter()
    out = bsh.run_waveguide_box_sharded(devmesh, mesh.structure, spec,
                                        source, receiver, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _grad_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    ref = wgrun.run_waveguide_box(mesh.structure, spec, source, receiver, n,
                                  kernel_inject=False)
    (ia, pa), (ib, pb) = out["outputs"], ref["outputs"]
    peak = float(pb.abs().max())
    err = float((pa - pb).abs().max())
    ierr = float((ia - ib).abs().max())
    ipeak = float(ib.abs().max())
    print(f"[33 box sharded] {spec.dims} on {SHARDS} x cuda:0 (mesh setup "
          f"{setup_s:.2f} s), source at the centre (x {desc.locator(src)[0]}, "
          f"a shard boundary), {n} steps: stable {bool(out['stable'])}, "
          f"launches {counts}; against the single-device fused run: max "
          f"|Δp| {err:.3e} = {err / peak:.3e} of peak, intensity "
          f"{ierr / ipeak:.3e} of peak (bound {BOX_SHARDED_REL:g})")
    print(f"[33 box sharded] sharded wall {1e3 * wall / n:.4f} ms/step, peak "
          f"memory {peak_mem / 2**20:.1f} MiB [{card}]")
    if not (bool(out["stable"]) and peak > 0
            and err <= BOX_SHARDED_REL * peak
            and ierr <= BOX_SHARDED_REL * ipeak
            and counts["box_fused_step"] == SHARDS * n):
        _fail("the sharded shoebox run failed its checks")

    # the gradient: 3 nodes from the low y wall, one node from the first
    # shard boundary in x, taps 2 nodes further from the wall
    xb = spec.dims[0] // SHARDS
    mid_z = (spec.ilo[2] + spec.ihi[2]) // 2
    g_src = tuple(desc.position(np.array([xb - 1, spec.ilo[1] + 3, mid_z])))
    g_rcv = tuple(desc.position(np.array([xb, spec.ilo[1] + 5, mid_z])))
    f64_state = _box_sharded_f64_state(torch, devmesh, mesh, g_src, g_rcv,
                                       card)
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, g_src, g_rcv, _hall_sim_time(mesh, 16))
    receiver = _tap_receiver(receiver)

    def grad(run):
        coef_b = mesh.structure.coef_b.detach().clone().requires_grad_(True)
        loss = torch.sum(run(dataclasses.replace(
            mesh.structure, coef_b=coef_b))["outputs"] ** 2)
        loss.backward()
        return coef_b.grad

    _reset_grad_counts()
    t0 = time.perf_counter()
    g_sh = grad(lambda s: bsh.run_waveguide_box_sharded(
        devmesh, s, spec, source, receiver, n))
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t0
    grad_counts = _grad_counts()
    g_si = grad(lambda s: wgrun.run_waveguide_box(
        s, spec, source, receiver, n, kernel_inject=False))
    scale = float(g_si.abs().max())
    rel = float((g_sh - g_si).abs().max()) / scale if scale > 0 \
        else float("inf")
    print(f"[33 box sharded] {n}-step gradient, source 3 nodes from the low "
          f"y wall beside the first shard boundary: max |Δ d/dcoef_b| "
          f"{rel:.3e} of the largest component {scale:.4e} (bound "
          f"{GRAD_REL:g}); value and gradient {t_sh:.3f} s; launches "
          f"{grad_counts} [{card}]")
    if not (rel <= GRAD_REL
            and grad_counts["box_fused_step"] == SHARDS * n
            and 0 < grad_counts["box_fused_step_bwd"] <= SHARDS * n):
        _fail("the sharded shoebox gradient failed its checks")
    b5_shard = _b5_shard_time(torch, spec, card)
    result = {"dims": list(spec.dims), "shards": SHARDS, "steps": steps,
              "wall_ms_per_step": 1e3 * wall / steps,
              "rel_err_vs_single": err / peak, "grad_rel_err": rel,
              "peak_memory_bytes": peak_mem,
              "launches": counts, "grad_launches": grad_counts,
              "f64_state": f64_state, "b5_shard": b5_shard}
    print(json.dumps({"phase": "33 box sharded", **result}))
    return result


def _box_sharded_f64_state(torch, devmesh, mesh, src, rcv, card):
    """``run_waveguide_box_sharded(…, state_dtype=torch.float64)``: the
    boundary filters' state in float64 on 4 shards, 32 steps from a source
    3 nodes from a wall, against the single-device fused run with the same
    state dtype, at the sharded shoebox's bound."""
    from wayverb_tpu_torch.parallel import box_sharded as bsh
    from wayverb_tpu_torch.waveguide import run as wgrun
    spec = mesh.box_spec
    source, receiver, n, _ = wgrun.canonical_problem(
        mesh, src, rcv, _hall_sim_time(mesh, F64_STATE_STEPS))
    _reset_grad_counts()
    t0 = time.perf_counter()
    out = bsh.run_waveguide_box_sharded(devmesh, mesh.structure, spec,
                                        source, receiver, n,
                                        state_dtype=torch.float64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _grad_counts()
    ref = wgrun.run_waveguide_box(mesh.structure, spec, source, receiver, n,
                                  kernel_inject=False,
                                  state_dtype=torch.float64)
    (ia, pa), (ib, pb) = out["outputs"], ref["outputs"]
    peak = float(pb.abs().max())
    err = float((pa - pb).abs().max())
    ierr, ipeak = float((ia - ib).abs().max()), float(ib.abs().max())
    print(f"[33 box sharded] state_dtype=float64, {n} steps from 3 nodes off "
          f"the low y wall: stable {bool(out['stable'])}, fields "
          f"{pa.dtype}, launches {counts}; against the single-device fused "
          f"run with float64 state: max |Δp| {err:.3e} = "
          f"{err / peak:.3e} of peak, intensity {ierr / ipeak:.3e} of peak "
          f"(bound {BOX_SHARDED_REL:g}); {1e3 * wall / n:.3f} ms/step "
          f"[{card}]")
    if not (bool(out["stable"]) and bool(ref["stable"]) and peak > 0
            and ipeak > 0 and pa.dtype == torch.float32
            and err <= BOX_SHARDED_REL * peak
            and ierr <= BOX_SHARDED_REL * ipeak
            and counts["box_fused_step"] == SHARDS * n):
        _fail("the sharded shoebox with float64 state failed its checks")
    return {"steps": n, "rel_err_vs_single": err / peak,
            "intensity_rel_err": ierr / ipeak,
            "wall_ms_per_step": 1e3 * wall / n, "launches": counts}


def _b5_shard_time(torch, spec, card):
    """B5 alone on the second of the shoebox hall's x-shards, as the
    sharded gradient launches it (halo cotangents out), with the stream
    held; its bound."""
    from wayverb_tpu_torch.tools.mega_timing import b5_bound
    from wayverb_tpu_torch.waveguide.box_fused import (_plane_shapes,
                                                       fused_step_bwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    X, Y, Z = spec.dims
    dims = (X // SHARDS, Y, Z)
    g = torch.randn(*dims, generator=gen, device="cuda")
    ginner = tuple(torch.randn(*s, generator=gen, device="cuda")
                   for s in _plane_shapes(*dims))
    geom = spec.geom_array(x_offset=dims[0])
    us, host_us = _device_time_us(torch, lambda: fused_step_bwd(geom, g,
                                                                ginner), 100)
    bound_us, by = b5_bound(dims)
    print(f"[33 box sharded] B5 alone at the shard shape {dims} with halos: "
          f"{us:.2f} us a launch on the device ({host_us:.1f} us a call on "
          f"the host), bound {bound_us:.2f} us by {by}, "
          f"{us / bound_us:.2f}x [{card}]")
    return {"shape": list(dims), "ms": us / 1e3, "host_ms": host_us / 1e3,
            "bound_ms": bound_us / 1e3, "bound_by": by}


def phase_sharded_trace(torch, card):
    """``sharded_trace`` on 4 shards of the card: the box of
    tests/test_sharding.py, absorbing walls, one bounce, 65,536 rays in all
    as there (8 x 8192)."""
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.parallel.sharding import sharded_trace
    box = Box((0.0, 0.0, 0.0), (5.56, 3.97, 2.81))
    surf = Surface(absorption=torch.full((1, 8), 1.0),
                   scattering=torch.full((1, 8), 0.0))
    src, rcv = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)
    t0 = time.perf_counter()
    hist = sharded_trace(_device_mesh(), "x", box_scene(box), surf, src, rcv,
                         torch.Generator(device="cuda").manual_seed(SEED),
                         rays_per_device=RAYS // SHARDS, depth=1,
                         max_time=0.2)
    total = float(hist.sum())
    dt = time.perf_counter() - t0
    r = float(np.linalg.norm(np.subtract(src, rcv)))
    want = 8 / (4 * np.pi * r * r)
    print(f"[34 sharded trace] {SHARDS} x {RAYS // SHARDS} rays on cuda:0, "
          f"histogram on "
          f"{hist.device}: direct energy {total:.5f} against 8/(4πr²) = "
          f"{want:.5f} ({total / want - 1:+.3%}, bound ±30%) in {dt:.2f} s "
          f"[{card}]")
    print(json.dumps({"phase": "34 sharded trace", "rays": RAYS,
                      "direct_energy": total, "expected": want,
                      "seconds": dt}))
    if not (hist.is_cuda and abs(total - want) <= 0.3 * want):
        _fail("sharded_trace's energy is off")


# ---------------------------------------------------------------------------
# the residency probe: P1

PROBE_CASES = (            # (dims, K, resident, tile: None = plan_tiles')
    ((12, 9, 7), 5, True, None), ((12, 9, 7), 1, True, None),
    ((12, 9, 7), 5, False, None), ((12, 9, 7), 6, True, (5, 4, 3)),
    ((24, 10, 40), 3, True, (1, 5, 20)),
    ((15, 19, 21), 7, True, None), ((15, 19, 21), 1, True, None),
    ((15, 19, 21), 7, False, None),
    ((64, 224, 256), 6, True, None), ((64, 224, 256), 5, True, None),
    ((64, 224, 256), 6, False, None), ((128, 224, 256), 3, False, None))
PROBE_LINE = ((64, 224, 256), 64)   # the kernels line's shape and K
PROBE_STREAMED = (128, 224, 256)    # its device-memory figure, above L2
PROBE_PLAIN_K = 8


def phase_probe(torch, card):
    """P1 (the residency probe's kernel) against its plain version to the
    bit (max |Δ| 0.0) in every form: one cluster (the T30 box's grid,
    (12, 9, 7)), a cooperative grid of clusters (the worked placement
    (64, 224, 256) at even and odd K, given tiles cut in x, y and z) and
    device memory (above 50 MB too); its occupancy in each form; a
    resident grid that cannot be placed raises before any launch.  Then
    the sweep of ``python -m wayverb_tpu_torch.tools.probe_resident`` (the
    probe's main path, its launches counted), its scalars against each
    other and against the plain version, and the plain version's time."""
    from wayverb_tpu_torch.tools import probe_resident as pr
    cap = pr.resident_capacity("cuda")
    print(f"[35 probe] {cap.sms} SMs, {cap.smem_per_cta} B of shared memory "
          f"a CTA (opt-in), L2 {cap.l2_bytes} B, clusters of 2..16 resident "
          f"at once {dict(cap.clusters)} [{card}]", flush=True)
    occ = {"resident": pr.occupancy(PROBE_LINE[0], True),
           "one_cluster": pr.occupancy(pr.T30_DIMS, True),
           "device_memory": pr.occupancy(PROBE_STREAMED, False)}
    for form, o in occ.items():
        print(f"[35 probe] occupancy, {form}: {json.dumps(o)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    err_abs = 0.0
    for dims, K, resident, tile in PROBE_CASES:
        cur = torch.randn(dims, generator=gen, device="cuda")
        prev = torch.randn(dims, generator=gen, device="cuda")
        got = pr.resident_chunk(cur, prev, K, resident=resident, tile=tile)
        want = pr.chunk_plain(cur, prev, K)
        torch.cuda.synchronize()
        e_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        place = pr.plan_tiles(dims, cap, tile).describe() if resident \
            else f"{pr.resident_chunk.last_grid['ctas']} CTAs"
        print(f"[35 probe] P1 vs plain {list(dims)} K={K} "
              f"{'resident' if resident else 'device memory'} ({place}): "
              f"max |Δ| {e_abs:.3e}, equal {equal} (gate: to the bit)",
              flush=True)
        if not (equal and e_abs == 0.0):
            _fail(f"P1 disagrees with its plain version at {dims}, K={K}, "
                  f"resident={resident}")
        err_abs = max(err_abs, e_abs)
    big = torch.zeros(PROBE_STREAMED, device="cuda")
    before = pr.resident_chunk.launches
    try:
        pr.resident_chunk(big, big, 2)
    except ValueError as e:   # plan_tiles' refusal, raised before a launch
        refusal = str(e)
    else:
        _fail(f"a resident run of {PROBE_STREAMED} did not raise")
    if pr.resident_chunk.launches != before:
        _fail("the refused resident run launched")
    print(f"[35 probe] resident {list(PROBE_STREAMED)} refused before any "
          f"launch: {refusal}")
    del big

    pr.resident_chunk.launches = 0
    t0 = time.perf_counter()
    rows = pr.sweep("cuda")
    sweep_s = time.perf_counter() - t0
    launches = pr.resident_chunk.launches
    for row in rows:
        print("[35 probe] " + json.dumps(row))
    print(f"[35 probe] sweep: {len(rows)} rows, {launches} P1 launches in "
          f"{sweep_s:.2f} s [{card}]", flush=True)
    ran = [r for r in rows if r.get("fits", True)]
    if not launches or not all(r["ok"] for r in ran):
        _fail("the probe's sweep did not run or gave a non-finite value")
    if any(not r.get("fits", True) for r in rows
           if tuple(r["shape"]) in ((64, 224, 256), (32, 224, 256),
                                    (15, 19, 21))):
        _fail("a resident shape that fits the card was not placed")
    # each row runs 512 sub-steps from the same impulse: one value a shape
    for dims in pr.SWEEP_SHAPES:
        values = {r["value"] for r in ran if tuple(r["shape"]) == dims}
        if len(values) != 1:
            _fail(f"the sweep's rows at {dims} disagree: {values}")
    for dims in (pr.T30_DIMS, PROBE_LINE[0]):
        want = float(pr.chunk_plain(*pr.impulse_fields(dims, "cuda"),
                                    512)[0][8, 8, :8].sum())
        got = next(r["value"] for r in ran if tuple(r["shape"]) == dims)
        print(f"[35 probe] Σ cur[8, 8, :8] after 512 sub-steps at "
              f"{list(dims)}: sweep {got!r}, plain {want!r}")
        if got != want:
            _fail(f"the sweep's scalar at {dims} is not the plain version's")

    dims, K = PROBE_LINE
    cur = torch.randn(dims, generator=gen, device="cuda")
    prev = torch.randn(dims, generator=gen, device="cuda")
    pr.chunk_plain(cur, prev, PROBE_PLAIN_K)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    pr.chunk_plain(cur, prev, PROBE_PLAIN_K)
    stop.record()
    torch.cuda.synchronize()
    plain_us = 1e3 * start.elapsed_time(stop) / PROBE_PLAIN_K
    row = next(r for r in rows if tuple(r["shape"]) == dims
               and r["mode"] == "resident" and r["K"] == K)
    streamed = next(r for r in rows if tuple(r["shape"]) == PROBE_STREAMED
                    and r["mode"] == "device_memory" and r["K"] == K)
    print(f"[35 probe] P1 at {list(dims)}, K={K}: resident "
          f"{row['us_per_step']:.3f} us a sub-step (bound "
          f"{row['bound_us']:.3f}, {row['bound_by']}), plain "
          f"{plain_us:.1f}; device memory at {list(PROBE_STREAMED)} "
          f"{streamed['us_per_step']:.3f} us (bound "
          f"{streamed['bound_us']:.3f}) [{card}]", flush=True)
    return {"launches": launches, "max_abs_err": err_abs, "row": row,
            "streamed": streamed, "plain_us": plain_us, "sweep_s": sweep_s,
            "occupancy": occ}


# ---------------------------------------------------------------------------
# the directional receiver on the mega route: tools/bench/mega_check.py

MEGA_CHECK_REL = 5e-4      # the reference's forward_rel (MEGA_CHECK_r05.json)
MEGA_CHECK_STEPS = 128
MEGA_CHECK_CHUNK = 64


def phase_mega_check(torch, card):
    """The forward half of the reference's ``tools/bench/mega_check.py`` on
    the card: the hall box of DX · (s − 4) for (224, 224, 256), absorption
    0.12, fs 3333.33 Hz, a hard calibrated impulse at the centre and
    ``make_directional_receiver`` 8 nodes off it in z, 128 steps through
    ``run_waveguide_box`` (B1) and ``run_waveguide_box_mega(..., chunk=64)``
    (B2).  Each output's max |Δ| over its peak ≤ 5e-4, both routes
    ``stable``, exactly 128 B1 and 2 B2 launches.  The tool's
    finite-difference half is left out (ROADMAP §C)."""
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    from wayverb_tpu_torch.waveguide.box_mega import (mega_chunk,
                                                      run_waveguide_box_mega)
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.receivers import \
        make_directional_receiver
    from wayverb_tpu_torch.waveguide.sources import (
        HardSource, impulse_signal, rectilinear_calibration_factor)
    env, fs, steps = Environment(), 3333.33, MEGA_CHECK_STEPS
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    box = Box((0, 0, 0), tuple(dx * (s - 4) for s in (224, 224, 256)))
    t0 = time.perf_counter()
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.12), dx, fs,
                              device="cuda")
    setup_s = time.perf_counter() - t0
    desc = mesh.descriptor
    centre = np.asarray(box.centre())
    src_loc = mesh.require_inside(tuple(centre))
    rcv_loc = mesh.require_inside(tuple(centre + np.asarray([0, 0, 8 * dx])))
    source = HardSource(
        node_idx=desc.flat_index(src_loc),
        signal=impulse_signal(steps, rectilinear_calibration_factor(
            desc.spacing, env.acoustic_impedance), "cuda"))
    receiver = make_directional_receiver(
        desc, desc.sample_rate(env.speed_of_sound), env.ambient_density,
        desc.position(rcv_loc), "cuda")
    fused_step.launches = mega_chunk.launches = 0
    t0 = time.perf_counter()
    ref = wgrun.run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                  receiver, steps)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    b1 = fused_step.launches
    t0 = time.perf_counter()
    mega = run_waveguide_box_mega(mesh.structure, mesh.box_spec, source,
                                  receiver, steps, chunk=MEGA_CHECK_CHUNK)
    torch.cuda.synchronize()
    mega_s = time.perf_counter() - t0
    b2, b1_after = mega_chunk.launches, fused_step.launches
    rel = {}
    for k, name in enumerate(("intensity", "pressure")):
        a, b = ref["outputs"][k], mega["outputs"][k]
        rel[name] = float((a - b).abs().max()) \
            / (float(a.abs().max()) + 1e-30)
    stable = {"fused": bool(ref["stable"]), "mega": bool(mega["stable"])}
    print(f"[44 mega check] {list(desc.dimensions)}, absorption 0.12, fs "
          f"{fs} Hz, mesh {setup_s:.2f} s; directional receiver 8 nodes "
          f"off the centre impulse in z, {steps} steps: fused (B1) "
          f"{fused_s:.3f} s, {b1} B1 launches; mega (B2, chunk "
          f"{MEGA_CHECK_CHUNK}) {mega_s:.3f} s, {b2} B2 launches; max |Δ| "
          f"over peak: intensity {rel['intensity']:.3e}, pressure "
          f"{rel['pressure']:.3e} (bound {MEGA_CHECK_REL:g}; the TPU's "
          f"3.02e-07 / 6.34e-07); stable {stable} [{card}]", flush=True)
    if not (max(rel.values()) <= MEGA_CHECK_REL and all(stable.values())
            and b1 == steps and b1_after == steps
            and b2 == steps // MEGA_CHECK_CHUNK):
        _fail("the directional receiver's mega check failed")
    return {"shape": list(desc.dimensions), "steps": steps,
            "forward_rel": rel, "stable": stable, "b1_launches": b1,
            "b2_launches": b2, "fused_s": fused_s, "mega_s": mega_s,
            "setup_s": setup_s}


# ---------------------------------------------------------------------------
# resume, cancel and the project file: the chunked runner, run_project

RESUME_STEPS = 256         # the resumable hall: 4 chunks of 64
RESUME_CHUNK = 64
RESUME_VS_MEGA_REL = 1e-5  # chunked (B1) against execute (B2), of peak


def _outputs_equal(torch, a, b):
    if isinstance(a, tuple):
        return all(_outputs_equal(torch, x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(a, b))


def _cat_outputs(torch, pieces):
    if isinstance(pieces[0], tuple):
        return tuple(torch.cat(p) for p in zip(*pieces))
    return torch.cat(pieces)


def _synced(torch, fn):
    """(fn(), seconds), the clock stopped after a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_resumable_hall(torch, box, dx, mesh, card):
    """The hall of phases 5-7 through the chunked runner: ``run_cancellable``
    in chunks of 64, a cancel after two chunks resumed from
    ``Cancelled.state``, a ``save_state`` at step 128 loaded back onto the
    card and resumed, and ``iter_pressure_fields(every=64)``: each
    bit-equal to one continuous ``run_waveguide_box`` (B1 a step), and
    against ``execute`` (B2)."""
    from wayverb_tpu_torch.utils.events import iter_pressure_fields
    from wayverb_tpu_torch.waveguide import checkpoint as ck
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    src, rcv = _hall_positions(box, dx)
    source, receiver, steps, _ = wgrun.canonical_problem(
        mesh, src, rcv, _hall_sim_time(mesh, RESUME_STEPS))
    launches = {}

    def counted(name, fn):
        fused_step.launches = 0
        out, secs = _synced(torch, fn)
        launches[name] = fused_step.launches
        return out, secs

    # a short warm-up, so neither form pays the first launches' costs
    wgrun.run_waveguide_box(mesh.structure, mesh.box_spec, source, receiver,
                            8)
    want, cont_s = counted("continuous", lambda: wgrun.run_waveguide_box(
        mesh.structure, mesh.box_spec, source, receiver, steps))
    chunk_s = []

    def chunked():
        marks = [time.perf_counter()]

        def progress(step, target):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        out = ck.run_cancellable(mesh, source, receiver, steps,
                                 keep_going=lambda: True, chunk=RESUME_CHUNK,
                                 on_progress=progress)
        chunk_s.extend(b - a for a, b in zip(marks, marks[1:]))
        return out

    (state, outputs), chunked_s = counted("chunked", chunked)
    calls = iter([True, True, False])

    def cancel_and_resume():
        try:
            ck.run_cancellable(mesh, source, receiver, steps,
                               keep_going=lambda: next(calls),
                               chunk=RESUME_CHUNK)
        except ck.Cancelled as stop:
            part = stop
        else:
            _fail("run_cancellable did not stop when keep_going went False")
        rest = ck.run_cancellable(mesh, source, receiver,
                                  steps - part.state.step,
                                  keep_going=lambda: True,
                                  chunk=RESUME_CHUNK, state=part.state)
        return part, rest

    (part, (_, rest)), _ = counted("cancelled", cancel_and_resume)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hall.npz")

        def save_load_resume():
            first_state, first = ck.run_chunk(
                mesh, source, receiver, ck.initial_state(mesh, receiver),
                steps // 2)
            _, save_s = _synced(torch, lambda: ck.save_state(path,
                                                             first_state))
            loaded, load_s = _synced(torch, lambda: ck.load_state(
                path, mesh, receiver, device="cuda"))
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                ck.state_leaves(loaded), ck.state_leaves(first_state)))
            _, second = ck.run_chunk(mesh, source, receiver, loaded,
                                     steps - steps // 2)
            return first, second, save_s, load_s, same, os.path.getsize(path)

        (first, second, save_s, load_s, loaded_same, snap_bytes), _ = \
            counted("saved", save_load_resume)
    snaps, _ = counted("snapshots", lambda: list(iter_pressure_fields(
        mesh, source, receiver, steps, every=RESUME_CHUNK)))
    mega = wgrun.execute(mesh, source, receiver, steps)
    torch.cuda.synchronize()

    fields = [f for _, f, _ in snaps]
    nonzero = all(bool(torch.any(f != 0)) for f in fields)
    distinct = all(not bool(torch.equal(a, b))
                   for i, a in enumerate(fields) for b in fields[i + 1:])
    forms = {
        "chunked": _outputs_equal(torch, outputs, want["outputs"]),
        "cancelled": _outputs_equal(torch, _cat_outputs(
            torch, [part.outputs, rest]), want["outputs"]),
        "saved": _outputs_equal(torch, _cat_outputs(torch, [first, second]),
                                want["outputs"]) and loaded_same,
        "snapshots": _outputs_equal(torch, _cat_outputs(
            torch, [o for _, _, o in snaps]), want["outputs"])}
    _, pressure = outputs
    _, mega_p = mega["outputs"]
    peak = float(mega_p.abs().max())
    mega_rel = float((pressure - mega_p).abs().max()) / peak
    print(f"[38 resumable hall] {mesh.descriptor.dimensions}, {steps} steps: "
          f"B1 launches {launches}; bit-equal to "
          f"run_waveguide_box: {forms}; cancelled at step {part.state.step}; "
          f"stable {bool(state.stable)}")
    print(f"[38 resumable hall] continuous {1e3 * cont_s / steps:.4f} "
          f"ms/step; chunked {1e3 * chunked_s / steps:.4f} ms/step, chunks "
          f"{[round(1e3 * s, 2) for s in chunk_s]} ms each; save_state "
          f"{save_s:.3f} s, load_state onto the card {load_s:.3f} s, "
          f"{snap_bytes} bytes; iter_pressure_fields: {len(fields)} "
          f"snapshots at {[s for s, _, _ in snaps]}, nonzero {nonzero}, "
          f"distinct {distinct} after the run; against execute (B2): max "
          f"|dp| / peak {mega_rel:.3e} (bound {RESUME_VS_MEGA_REL:g}) "
          f"[{card}]")
    if not (all(forms.values()) and part.state.step == 2 * RESUME_CHUNK
            and all(n == steps for n in launches.values())
            and bool(state.stable) and bool(want["stable"])
            and len(fields) == steps // RESUME_CHUNK and nonzero and distinct
            and mega_rel <= RESUME_VS_MEGA_REL):
        _fail("the resumable hall failed its checks")
    return {"shape": list(mesh.descriptor.dimensions), "steps": steps,
            "chunk": RESUME_CHUNK, "b1_launches": launches,
            "continuous_ms_per_step": 1e3 * cont_s / steps,
            "chunked_ms_per_step": 1e3 * chunked_s / steps,
            "chunk_ms": [1e3 * s for s in chunk_s],
            "save_s": save_s, "load_s": load_s, "snapshot_bytes": snap_bytes,
            "vs_execute_rel": mega_rel}


def _resume_case(torch, tag, mesh, source, receiver, steps, chunks, counter,
                 continuous, card):
    """Chunked against one continuous run on a route; the route's kernel
    must launch once a step in both."""
    from wayverb_tpu_torch.waveguide import checkpoint as ck
    counter.launches = 0
    want, cont_s = _synced(torch, continuous)
    cont_launches = counter.launches
    counter.launches = 0

    def chunked():
        state, pieces = ck.initial_state(mesh, receiver), []
        for n in chunks:
            state, out = ck.run_chunk(mesh, source, receiver, state, n)
            pieces.append(out)
        return state, _cat_outputs(torch, pieces)

    (state, got), chunked_s = _synced(torch, chunked)
    chunk_launches = counter.launches
    equal = _outputs_equal(torch, got, want["outputs"])
    print(f"[{tag}] {mesh.descriptor.dimensions}, {steps} steps as "
          f"{list(chunks)} against one run: bit-equal {equal}, stable "
          f"{bool(state.stable)}; launches {chunk_launches} chunked, "
          f"{cont_launches} continuous; {1e3 * chunked_s / steps:.4f} "
          f"against {1e3 * cont_s / steps:.4f} ms/step [{card}]")
    if not (equal and bool(state.stable)
            and chunk_launches == cont_launches == steps):
        _fail(f"{tag}: the chunked run differs from the continuous one")
    return {"shape": list(mesh.descriptor.dimensions), "steps": steps,
            "chunks": list(chunks), "launches": chunk_launches,
            "chunked_ms_per_step": 1e3 * chunked_s / steps,
            "continuous_ms_per_step": 1e3 * cont_s / steps}


def phase_resumable_general(torch, col_mesh, card):
    """The columns hall (B8) through ``run_chunk``, 100 steps as 4 x 25,
    against one ``run_waveguide``; it runs while phases 17-22's mesh is
    built."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    source, receiver, _, _ = wgrun.canonical_problem(
        col_mesh, COLUMNS_SRC, COLUMNS_RCV, 100 / COLUMNS_FS)
    return _resume_case(
        torch, "39 resumable general", col_mesh, source, receiver, 100,
        (25,) * 4, sk.weighted_step,
        lambda: wgrun.run_waveguide(col_mesh.structure,
                                    col_mesh.descriptor.dimensions, source,
                                    receiver, 100), card)


def phase_resumable_thin(torch, card):
    """Phase 20's thin box (B12) through ``run_chunk``, 150 steps as
    3 x 50, against one ``run_waveguide_regions``."""
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    mesh = wgrun.shoebox_mesh(Box((0.0, 0.0, 0.0), (1.4, 1.6, 0.5)),
                              np.full((1, 8), ABSORPTION), dx, FS,
                              anchor=(0.7, 0.8, 0.25 + dx / 2),
                              device="cuda")
    if mesh.box_spec is not None or mesh.regions is None:
        _fail("the thin box did not route to the region path")
    steps = 150
    source, receiver, _, _ = wgrun.canonical_problem(
        mesh, (0.5, 0.6, 0.2), (0.9, 1.1, 0.3), steps / FS)
    return _resume_case(
        torch, "39 resumable thin", mesh, source, receiver, steps,
        (steps // 3,) * 3, sk.interior_step,
        lambda: wgrun.run_waveguide_regions(
            mesh.structure, mesh.descriptor.dimensions, source, receiver,
            steps, mesh.regions), card)


def _hall_project(out_dir):
    """Phase 9's hall as a project: one source, two receivers, each with
    an omni, a cardioid and both ears of ``Hrtf``; 16-bit WAV."""
    from wayverb_tpu_torch.combined import model as pm
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    dx = grid_spacing(340.0, 1.0 / FS)
    box = _hall_box(dx)
    src, rcv = (np.asarray(p, dtype=np.float64)
                for p in _hall_positions(box, dx))
    off = np.asarray([3.0, -2.0, 1.0])
    point = lambda p: tuple(float(v) for v in p)  # noqa: E731  (JSON)
    capsules = [pm.CapsuleModel("omni"),
                pm.CapsuleModel("cardioid", shape=0.5),
                pm.CapsuleModel("left", "hrtf", channel=0),
                pm.CapsuleModel("right", "hrtf", channel=1)]
    project = pm.Project(
        sources=[pm.SourceModel("a", point(src))],
        receivers=[pm.ReceiverModel("x", point(rcv), capsules=capsules),
                   pm.ReceiverModel("y", point(rcv - off),
                                    capsules=capsules)],
        materials=[pm.MaterialModel("hall", [ABSORPTION] * 8, [0.1] * 8)],
        waveguide=pm.WaveguideModel(cutoff=500.0, usable_portion=0.6),
        output=pm.OutputModel(sample_rate=44100.0, bit_depth="pcm16",
                              output_directory=out_dir, unique_id="hall"))
    return box, project


def phase_project(torch, card):
    """A project file rendered on the card: ``Project.save``/``load``, then
    ``run_project`` (8 WAV files), every file read back; the first pair
    again through ``Engine.run`` + ``render`` (under ``profiler_trace``)
    with the same generator seed.  Both runs use the deterministic algorithms
    (``index_add_`` among them), so that pair can equal to the bit."""
    import warnings

    from wayverb_tpu_torch.combined import complete
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.combined.model import Project
    from wayverb_tpu_torch.core.geometry import box_scene
    from wayverb_tpu_torch.utils.audio import read_wav
    from wayverb_tpu_torch.utils.events import profiler_trace
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    seed = SEED + 40
    marks = []

    def mark(state, progress):
        torch.cuda.synchronize()
        marks.append((state, time.perf_counter()))

    was = torch.are_deterministic_algorithms_enabled()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warn_only's notes
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            box, project = _hall_project(tmp)
            project.save(os.path.join(tmp, "hall.json"))
            project = Project.load(os.path.join(tmp, "hall.json"))
            mega_chunk.launches = 0
            t0 = time.perf_counter()
            channels = complete.run_project(
                project, box_scene(box),
                torch.Generator(device="cuda").manual_seed(seed),
                scene_box=box, state_callback=mark, device="cuda")
            total_s = time.perf_counter() - t0
            b2 = mega_chunk.launches
            src, rcv = project.sources[0], project.receivers[0]
            gen = torch.Generator(device="cuda").manual_seed(seed)
            e = eng.Engine(box_scene(box),
                           project.surface_table(device="cuda"),
                           eng.WaveguideParameters(cutoff=500.0,
                                                   usable_portion=0.6),
                           scene_box=box, device="cuda")
            results = e.run(src.position, rcv.position, gen,
                            eng.RaytracerParameters())
            # the renders under the profiler: Engine.run makes ~170,000
            # launches (a 345 MB trace, ~20 s of profiling), its renders few
            trace_dir = os.path.join(tmp, "profile")
            t0 = time.perf_counter()
            with profiler_trace(trace_dir) as prof:
                irs = [eng.render(results, c.build(), 44100.0, gen)
                       .cpu().numpy() for c in rcv.capsules]
            profiled_s = time.perf_counter() - t0
            busiest = sorted(prof.key_averages(), key=lambda a: -a.count)[:4]
            top_ops = {a.key: a.count for a in busiest}
        finally:
            torch.use_deterministic_algorithms(was)
        trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
        read_err, read_ok = 0.0, True
        for c in channels:
            data, rate = read_wav(c.path)
            read_ok = read_ok and rate == 44100.0 \
                and data.shape == (1, c.signal.size)
            if read_ok:
                read_err = max(read_err,
                               float(np.abs(data[0] - c.signal).max()))
        wavs = [f for f in os.listdir(tmp) if f.endswith(".wav")]

    times = [t for _, t in marks]
    names = [n for n, _ in marks]
    starts = [i for i, n in enumerate(names) if n.startswith("rendering ")]
    setup_s = times[starts[0]] - times[0]
    pair_s = [times[j] - times[i] for i, j in
              zip(starts, starts[1:] + [names.index("writing files")])]
    peak = max(float(np.abs(c.signal).max()) for c in channels)
    pair_diff = max(float(np.abs(c.signal - ir * c.scale).max())
                    for c, ir in zip(channels, irs))
    pair_equal = all(np.array_equal(c.signal, ir * c.scale)
                     for c, ir in zip(channels, irs))
    steps = results.waveguide_bands[0].pressure.shape[0]
    pairs = len(project.sources) * len(project.receivers)
    print(f"[40 project] phase 9's hall as a project, "
          f"{len(project.sources)} source x {len(project.receivers)} "
          f"receivers x 4 capsules, {project.raytracer.rays} rays: "
          f"setup {setup_s:.3f} s, pairs {[round(s, 3) for s in pair_s]} s, "
          f"run_project {total_s:.3f} s; B2 launches {b2} ({steps} steps a "
          f"pair); {len(channels)} channels, {len(wavs)} WAV files; largest "
          f"|x| over all channels {peak!r}; read back: max |d| {read_err:.3e} "
          f"(bound 1/32767 = {1 / 32767:.3e}) [{card}]")
    print(f"[40 project] pair ({src.name}, {rcv.name}) again by Engine.run + "
          f"render, same seed, scaled by run_project's {channels[0].scale!r}: "
          f"equal to the bit {pair_equal} (max |d| {pair_diff:.3e}); its "
          f"four renders under profiler_trace {profiled_s:.3f} s, trace.json "
          f"{trace_bytes} bytes, most frequent ops {top_ops} [{card}]")
    if not (len(channels) == len(wavs) == 4 * pairs
            and abs(peak - 1.0) <= 2 ** -24 and read_ok
            and read_err <= 1.0 / 32767 and pair_equal and trace_bytes > 0
            and b2 == pairs * math.ceil(steps / CHUNK)):
        _fail("the project on the card failed its checks")
    return {"channels": len(channels), "files": len(wavs),
            "setup_s": setup_s, "pair_s": pair_s, "run_project_s": total_s,
            "b2_launches": b2, "steps_a_pair": steps,
            "read_back_max_abs": read_err, "pair_bit_equal": pair_equal,
            "profiled_renders_s": profiled_s, "trace_bytes": trace_bytes,
            "profiled_top_ops": top_ops}


# ---------------------------------------------------------------------------
# several processes: parallel/distributed on one card

DIST_RANKS = 2             # gloo ranks, both on cuda:0 (NCCL refuses that)
DIST_SHARDS = SHARDS // DIST_RANKS   # shards a rank: 4 in all
DIST_TIMEOUT = 120         # s: the process group's collectives
DIST_LIMIT = 420           # s: the whole phase's children
DIST_BOX_STEPS, DIST_BOX_GRAD_STEPS = 64, 16
DIST_COL_STEPS, DIST_COL_GRAD_STEPS, DIST_CKPT = 100, 32, 16
DIST_GRAD_REL = 1e-5       # of the largest one-process component


def _dist_counts():
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    from wayverb_tpu_torch.waveguide.box_fused import (fused_step,
                                                       fused_step_bwd)
    return {"box_fused_step": fused_step.launches,
            "box_fused_step_bwd": fused_step_bwd.launches,
            "mesh_weighted_step_haloed": sk.weighted_step_sharded.launches,
            "mesh_weighted_step_haloed_bwd":
                sk.weighted_step_sharded_bwd.launches}


def _dist_reset():
    from wayverb_tpu_torch.parallel.sharding import reset_transport_stats
    from wayverb_tpu_torch.waveguide import stencil_kernels as sk
    from wayverb_tpu_torch.waveguide.box_fused import (fused_step,
                                                       fused_step_bwd)
    fused_step.launches = fused_step_bwd.launches = 0
    sk.weighted_step_sharded.launches = 0
    sk.weighted_step_sharded_bwd.launches = 0
    reset_transport_stats()


def _dist_measure(torch, fn):
    """``fn()`` timed from zeroed counts: (its result, seconds, launches,
    transport)."""
    from wayverb_tpu_torch.parallel.sharding import transport_stats
    torch.cuda.synchronize()
    _dist_reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _dist_counts(), \
        dict(transport_stats)


def _dist_grad(torch, run, structure):
    import dataclasses
    coef_b = structure.coef_b.detach().clone().requires_grad_(True)
    loss = torch.sum(run(dataclasses.replace(structure,
                                             coef_b=coef_b))["outputs"] ** 2)
    loss.backward()
    return coef_b.grad


def _dist_runs(torch, devmesh, hall, box, dx, columns):
    """The four waveguide runs of phase 41 on ``devmesh``: the shoebox hall
    (B1 forward, B5 backward) and the columns hall (B10, B11), each as
    (outputs or gradient, seconds, launches, transport)."""
    from wayverb_tpu_torch.parallel import box_sharded as bsh
    from wayverb_tpu_torch.parallel import general_sharded as gs
    from wayverb_tpu_torch.waveguide import run as wgrun
    spec, desc = hall.box_spec, hall.descriptor
    out = {}
    src, rcv = _hall_positions(box, dx)
    source, receiver, n, _ = wgrun.canonical_problem(
        hall, src, rcv, _hall_sim_time(hall, DIST_BOX_STEPS))
    bsh.run_waveguide_box_sharded(devmesh, hall.structure, spec, source,
                                  receiver, 2)
    out["box_forward"] = _dist_measure(
        torch, lambda: bsh.run_waveguide_box_sharded(
            devmesh, hall.structure, spec, source, receiver, n))
    # phase 33's gradient: beside the low y wall and the first shard
    # boundary
    xb = spec.dims[0] // SHARDS
    mid_z = (spec.ilo[2] + spec.ihi[2]) // 2
    g_src = tuple(desc.position(np.array([xb - 1, spec.ilo[1] + 3, mid_z])))
    g_rcv = tuple(desc.position(np.array([xb, spec.ilo[1] + 5, mid_z])))
    source, receiver, n, _ = wgrun.canonical_problem(
        hall, g_src, g_rcv, _hall_sim_time(hall, DIST_BOX_GRAD_STEPS))
    receiver = _tap_receiver(receiver)
    out["box_gradient"] = _dist_measure(torch, lambda: _dist_grad(
        torch, lambda s: bsh.run_waveguide_box_sharded(
            devmesh, s, spec, source, receiver, n), hall.structure))
    dims = columns.descriptor.dimensions
    source, receiver, n, _ = wgrun.canonical_problem(
        columns, COLUMNS_SRC, COLUMNS_RCV,
        (DIST_COL_STEPS - 0.5) / COLUMNS_FS)
    gs.run_waveguide_general_sharded(devmesh, columns.structure, dims,
                                     source, receiver, 2)
    out["columns_forward"] = _dist_measure(
        torch, lambda: gs.run_waveguide_general_sharded(
            devmesh, columns.structure, dims, source, receiver, n))
    # phase 31's gradient, checkpointed as phase 22's
    source, receiver, n, _ = wgrun.canonical_problem(
        columns, _beside_column(columns, 3), _beside_column(columns, 5),
        (DIST_COL_GRAD_STEPS - 0.5) / COLUMNS_FS)
    receiver = _tap_receiver(receiver)
    out["columns_gradient"] = _dist_measure(torch, lambda: _dist_grad(
        torch, lambda s: gs.run_waveguide_general_sharded(
            devmesh, s, dims, source, receiver, n,
            checkpoint_every=DIST_CKPT), columns.structure))
    return out


def _dist_host(value):
    """Tensors (or tuples, dicts of them) moved to the host for saving."""
    if isinstance(value, dict):
        return {k: _dist_host(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_dist_host(v) for v in value)
    if hasattr(value, "detach"):
        return value.detach().cpu()
    return value


def _rank_main(rank, world, port, out_dir):
    """One rank of phase 41: ``distributed.initialize`` (gloo) and a
    ``global_device_mesh`` of two shards of cuda:0 a rank; the four runs
    of ``_dist_runs`` and the sharded engine's run + render on the columns
    hall; everything saved to ``out_dir``.  The engine and the shoebox
    hall's mesh are the ones the parent built, loaded from ``out_dir``,
    the engine with the global mesh as its ``device_mesh`` (building the
    12.4 M-node mesh in two processes at once takes a minute)."""
    import warnings

    import torch
    sys.path.insert(0, ROOT)
    from wayverb_tpu_torch.combined import engine as eng
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.parallel import distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[41 rank {rank}]"
    t0 = time.perf_counter()
    dist.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                    timeout=DIST_TIMEOUT)
    gmesh = dist.global_device_mesh(devices=["cuda:0"] * DIST_SHARDS)
    print(f"{tag} process {rank} of {dist.process_count()}, coordinator "
          f"{dist.is_coordinator()}, shards {gmesh.local_shards} of owners "
          f"{gmesh.owners}; up in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    e = torch.load(os.path.join(out_dir, "engine.pt"), map_location="cuda:0",
                   weights_only=False)
    e.device_mesh = gmesh
    box, dx, hall = torch.load(os.path.join(out_dir, "hall.pt"),
                               map_location="cuda:0", weights_only=False)
    print(f"{tag} the sharded engine {e.mesh.descriptor.dimensions} and the "
          f"hall {hall.box_spec.dims} loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    res = {"owners": gmesh.owners, "local_shards": gmesh.local_shards,
           "runs": _dist_runs(torch, gmesh, hall, box, dx, e.mesh)}
    del hall
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warn_only's notes
        torch.use_deterministic_algorithms(True, warn_only=True)
        run = _dist_measure(torch, lambda: e.run(
            COLUMNS_SRC, COLUMNS_RCV,
            torch.Generator().manual_seed(SEED + 31),
            eng.RaytracerParameters(),
            waveguide_time=SHARDED_ENGINE_STEPS / COLUMNS_FS))
        ir = eng.render(run[0], Null(), 44100.0,
                        torch.Generator().manual_seed(SEED + 32))
    band = run[0].waveguide_bands[0]
    res["engine"] = ((ir, band.pressure, band.stable),) + run[1:]
    for name, (_, secs, counts, moved) in res["runs"].items():
        print(f"{tag} {name}: {secs:.3f} s, launches {counts}, "
              f"{moved['bytes_sent'] + moved['bytes_received']} bytes "
              f"exchanged, staging {moved['staging_s']:.4f} s, waiting "
              f"{moved['wait_s']:.4f} s", flush=True)
    torch.save(_dist_host(res), os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed
    torch.distributed.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_distributed(torch, engine, engine_ref, card):
    """Phase 41: two gloo ranks on cuda:0, two shards each, against the
    one-process ``["cuda:0"] * 4`` mesh: the shoebox hall (64 steps
    forward, a 16-step gradient), the columns hall (100 steps, a 32-step
    gradient checkpointed every 16) and the sharded engine (phase 32's
    run, 0.1 s of waveguide).  Forwards equal at 0.0, gradients within
    1e-5 of the largest component, both ranks' IRs equal to the bit, and
    a rank that fails or times out fails the phase."""
    box, dx, hall, _ = _hall_mesh(torch)
    ref = _dist_runs(torch, _device_mesh(), hall, box, dx, engine.mesh)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        own = engine.device_mesh
        engine.device_mesh = None
        try:
            torch.save(engine, os.path.join(tmp, "engine.pt"))
        finally:
            engine.device_mesh = own
        torch.save((box, dx, hall), os.path.join(tmp, "hall.pt"))
        del hall
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(DIST_RANKS), "--port", str(port), "--out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=env) for r in range(DIST_RANKS)]
        outs, timed_out = [], False
        try:
            for p in procs:
                left = max(DIST_LIMIT - (time.perf_counter() - t0), 1.0)
                try:
                    outs.append(p.communicate(timeout=left)[0])
                except subprocess.TimeoutExpired:
                    timed_out = True
                    p.kill()
                    outs.append(p.communicate()[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, out in enumerate(outs):
            print("\n".join(out.strip().splitlines()[-14:]), flush=True)
        rcs = [p.returncode for p in procs]
        if timed_out or any(rcs):
            _fail(f"a rank of phase 41 failed or timed out (exit codes "
                  f"{rcs}, {wall:.1f} s of {DIST_LIMIT} s)")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(DIST_RANKS)]
    result = {"ranks": DIST_RANKS, "shards_per_rank": DIST_SHARDS,
              "backend": "gloo", "children_wall_s": wall, "runs": {}}
    ok = True
    steps = {"box_forward": DIST_BOX_STEPS, "box_gradient":
             DIST_BOX_GRAD_STEPS, "columns_forward": DIST_COL_STEPS,
             "columns_gradient": DIST_COL_GRAD_STEPS}
    for name, (want, secs, counts, _) in ref.items():
        row = {"steps": steps[name], "one_process_ms_per_step":
               1e3 * secs / steps[name],
               "one_process_launches": counts, "per_rank": []}
        for r, res in enumerate(ranks):
            got, rsecs, rcounts, moved = res["runs"][name]
            if name.endswith("gradient"):
                w = want.cpu()
                scale = float(w.abs().max())
                err = float((got - w).abs().max()) / scale
                good = scale > 0 and err <= DIST_GRAD_REL
            else:
                err = max(float((g - w.cpu()).abs().max())
                          for g, w in zip(got["outputs"], want["outputs"]))
                good = err == 0.0 and bool(got["stable"])
            ok &= good
            row["per_rank"].append({
                "max_err": err, "ms_per_step": 1e3 * rsecs / steps[name],
                "launches": rcounts,
                "bytes_per_step": (moved["bytes_sent"]
                                   + moved["bytes_received"]) / steps[name],
                "staging_s": moved["staging_s"], "wait_s": moved["wait_s"],
                "messages": moved["messages"],
                "reductions": moved["reductions"]})
            print(f"[41 distributed] {name}, rank {r}: "
                  f"{'max |Δ| / largest' if name.endswith('gradient') else 'max |Δ|'}"
                  f" {err:.3e} against the one-process mesh; "
                  f"{1e3 * rsecs / steps[name]:.3f} ms/step (one process "
                  f"{1e3 * secs / steps[name]:.3f}); "
                  f"{row['per_rank'][-1]['bytes_per_step']:.0f} bytes a "
                  f"step exchanged, {moved['staging_s']:.4f} s staging, "
                  f"{moved['wait_s']:.4f} s waiting; launches {rcounts} "
                  f"[{card}]")
        result["runs"][name] = row
    expect = {"box_forward": ("box_fused_step", DIST_SHARDS * DIST_BOX_STEPS),
              "columns_forward": ("mesh_weighted_step_haloed",
                                  DIST_SHARDS * DIST_COL_STEPS)}
    for name, (kernel, n) in expect.items():
        ok &= all(res["runs"][name][2][kernel] == n for res in ranks)
    ok &= all(0 < res["runs"]["box_gradient"][2]["box_fused_step_bwd"]
              <= DIST_SHARDS * DIST_BOX_GRAD_STEPS
              and 0 < res["runs"]["columns_gradient"][2][
                  "mesh_weighted_step_haloed_bwd"]
              <= DIST_SHARDS * DIST_COL_GRAD_STEPS for res in ranks)
    (ir0, p0, st0), esecs, ecounts, emoved = ranks[0]["engine"]
    ir1, p1 = ranks[1]["engine"][0][:2]
    p_ref, ir_ref = engine_ref
    p_err = float((p0 - p_ref.cpu()).abs().max())
    ir_ranks_equal = torch.equal(ir0, ir1) and torch.equal(p0, p1)
    ir_err = float((ir0 - ir_ref.cpu()).abs().max()) \
        / float(ir_ref.abs().max()) if ir0.shape == ir_ref.shape \
        else float("inf")
    print(f"[41 distributed] the sharded engine with device_mesh="
          f"global_device_mesh(): the columns hall, {SHARDED_ENGINE_STEPS} "
          f"waveguide steps: both ranks' "
          f"IRs equal to the bit {ir_ranks_equal}; waveguide band max |Δp| "
          f"{p_err:.3e} against phase 32's one-process sharded run; IR "
          f"against phase 32's (its own ray draws) max |Δ| / peak "
          f"{ir_err:.3e}; rank 0 {esecs:.2f} s, launches {ecounts}, "
          f"{emoved['bytes_sent'] + emoved['bytes_received']} bytes "
          f"exchanged [{card}]")
    ok &= ir_ranks_equal and p_err == 0.0 and bool(st0) \
        and ecounts["mesh_weighted_step_haloed"] \
        == DIST_SHARDS * SHARDED_ENGINE_STEPS
    result["engine"] = {"ir_ranks_equal": ir_ranks_equal,
                        "band_max_abs_err": p_err, "ir_rel_err": ir_err,
                        "seconds": esecs, "launches": ecounts,
                        "bytes": emoved["bytes_sent"]
                        + emoved["bytes_received"]}
    result["distributed_launches"] = {
        k: [sum(run[2][k] for run in res["runs"].values())
            + res["engine"][2][k] for res in ranks]
        for k in ("box_fused_step", "box_fused_step_bwd",
                  "mesh_weighted_step_haloed",
                  "mesh_weighted_step_haloed_bwd")}
    print(json.dumps({"phase": "41 distributed", **result}))
    if not ok:
        _fail("the distributed waveguide failed its checks")
    return result


# ---------------------------------------------------------------------------
# the validation tools on the card

TOOL_ARGS = {"rt60": [], "mic_test": [], "siltanen2013": [],
             "level_match": [], "waveguide_distance_test": [],
             "solution_growth": [], "sheaffer2014": None,
             "boundary_test": []}
CANONICAL_TOOLS = ("rt60", "mic_test", "siltanen2013", "level_match")


def _tool_flags(name, report):
    """The pass flags a tool reports: ``stable`` wherever it prints one,
    and ``all_decaying``."""
    if name == "rt60":
        return {f"{room}.stable": r["stable"] for room, r in report.items()}
    if name == "solution_growth":
        flags = {f"{r['signal']}.{r['source']}.stable": r["stable"]
                 for r in report["runs"]}
        return {**flags, "all_decaying": report["all_decaying"]}
    return {"stable": report["stable"]} if "stable" in report else {}


def phase_tools(torch, card):
    """Phase 42: the eight waveguide validation tools at the reference's
    defaults, on the card through ``main()``: each one's report, its own
    pass flags, its B1 and B2 launches and seconds."""
    import contextlib
    import importlib
    import io
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    result, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in TOOL_ARGS.items():
            if argv is None:
                argv = ["--out-prefix", os.path.join(tmp, name)]
            module = importlib.import_module(
                f"wayverb_tpu_torch.tools.{name}")
            mega_chunk.launches = fused_step.launches = 0
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                report = module.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            flags = _tool_flags(name, report)
            launches = {"box_mega_chunk": mega_chunk.launches,
                        "box_fused_step": fused_step.launches}
            good = all(flags.values()) and (
                launches["box_mega_chunk"] > 0
                or name not in CANONICAL_TOOLS)
            ok &= good
            shown = {k: v for k, v in report.items()
                     if k not in ("freq_hz", "measured", "predicted",
                                  "valid")}
            if name == "boundary_test":
                valid = [i for i, v in enumerate(report["valid"]) if v]
                shown = {"valid_bins": len(valid), "max_abs_error": max(
                    abs(report["measured"][i] - report["predicted"][i])
                    for i in valid)}
            print(f"[42 tools] {name}: {secs:.2f} s, launches {launches}, "
                  f"flags {flags}, {len(printed.getvalue().splitlines())} "
                  f"lines printed; report {json.dumps(shown)} [{card}]",
                  flush=True)
            result[name] = {"seconds": secs, "launches": launches,
                            "flags": flags, "report": shown}
    print(json.dumps({"phase": "42 tools", **result}))
    if not ok:
        _fail("a validation tool failed its own checks on the card")
    return result


# ---------------------------------------------------------------------------
# the last eight tools on the card

LONGRUN_STEPS = 12000      # longrun --mode hw: its default, one B1 a step
LONGRUN_F64_STEPS = 2000
BOX_IR_REL = 1e-6          # box's IR, card vs CPU from one history, of peak
GUI_RENDER = {"source": [1.0, 1.2, 0.9], "receiver": [2.2, 1.4, 1.9],
              "rays": 512, "cutoff": 250, "absorption": 0.2}


def _png_size(path):
    """(width, height) of an 8-bit RGB PNG whose rows decode to that size
    (every chunk's CRC checked), or None."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, header = 8, b"", None
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            return None
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    if header is None or header[2:4] != (8, 2):
        return None
    width, height = header[:2]
    if len(zlib.decompress(idat)) != height * (1 + 3 * width):
        return None
    return width, height


def _wav_ok(path):
    """The WAV read back: finite and not all zero."""
    from wayverb_tpu_torch.utils.audio import read_wav
    data, _ = read_wav(path)
    return bool(data.size and np.all(np.isfinite(data))
                and np.abs(data).max() > 0)


def _synth_hrirs(directory):
    """Stereo HRIRs over 12 azimuths x 3 elevations with an interaural level
    difference (right ear louder for a source on the right), as the port's
    bake test synthesises them."""
    from wayverb_tpu_torch.utils.audio import write_wav
    for az in range(0, 360, 30):
        for el in (-40, 0, 40):
            lateral = np.sin(np.radians(az)) * np.cos(np.radians(el))
            ir = np.zeros((2, 512))
            for ch, side in ((0, -1.0), (1, 1.0)):
                k = int(round(0.0009 * (1 - lateral * side) / 2 * 44100)) + 8
                ir[ch, k] = 1.0 + 0.6 * lateral * side
                ir[ch, k + 1] = 0.3 * ir[ch, k]
            write_wav(os.path.join(directory, f"azel_az_{az}_el_{el}.wav"),
                      ir, 44100.0)


def _gui_loop(torch, gui, tmp, launches):
    """One render through the GUI's HTTP API on the card, as
    ``tests/test_gui.py::test_full_loop`` drives it, then a cancel;
    ``launches()`` is read when the render is done, before the cancel."""
    import threading
    import urllib.request

    def post(path, obj):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(obj).encode())
        return json.loads(urllib.request.urlopen(req).read())

    def get(path):
        return urllib.request.urlopen(base + path).read()

    def wait():
        deadline = time.time() + 300
        while True:
            p = json.loads(get("/api/progress"))
            if not p["running"] or time.time() > deadline:
                return p
            time.sleep(0.1)

    httpd = gui.serve(port=0, device="cuda")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        page = get("/").decode()
        scene = post("/api/load", {"dims": [3.2, 2.5, 2.8]})
        started = post("/api/render", GUI_RENDER)["started"]
        done = wait()
        counted = launches()
        res = json.loads(get("/api/result")) if done["has_result"] else {}
        ir = np.asarray(res.get("ir", []), dtype=np.float64)
        wav = os.path.join(tmp, "gui.wav")
        with open(wav, "wb") as f:
            f.write(get("/api/result.wav") if done["has_result"] else b"")
        post("/api/load", {"dims": [4.0, 3.0, 3.5]})
        cancel_started = post("/api/render", {
            "source": [1.0, 1.2, 0.9], "receiver": [2.8, 1.4, 2.4],
            "rays": 512, "cutoff": 200, "absorption": 0.3})["started"]
        post("/api/cancel", {})
        cancelled = wait()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    report = {"status": done["status"], "error": done["error"],
              "render_launches": counted,
              "ir_points": int(ir.size),
              "ir_peak": float(np.abs(ir).max()) if ir.size else 0.0,
              "rays": len(res.get("rays") or []),
              "frames": len(res.get("frames") or []),
              "cancel_status": cancelled["status"]}
    flags = {"page": "wayverb_tpu_torch" in page,
             "box_loaded": scene["num_triangles"] == 12 and scene["is_box"],
             "started": started and cancel_started,
             "done": done["status"] == "done" and done["error"] is None,
             "ir": bool(ir.size > 100 and np.all(np.isfinite(ir))
                        and np.abs(ir).max() > 0),
             "wav": done["has_result"] and _wav_ok(wav),
             "rays_and_frames": report["rays"] == 48
             and report["frames"] == 20,
             "cancelled": cancelled["status"] in ("cancelled", "done")
             and not cancelled["running"],
             "b2": counted["box_mega_chunk"] > 0,
             "b1_wavefront": counted["box_fused_step"] == 160}
    return report, flags


def phase_last_tools(torch, card):
    """Phase 43: the last eight tools of ``wayverb_tpu_torch/tools`` on the
    card through ``main()``: ``box``, ``diffuse_decay`` and
    ``boundary_fit_sweep`` at the reference's defaults; ``longrun --mode
    hw`` at its 12,000 steps (the fused route: one B1 launch a step, counted
    exactly); ``longrun --mode f64 --steps 2000``; ``crackly_tunnel`` at its
    defaults and ``visualize`` into a temporary directory; ``bake_hrtf`` on
    a set synthesised there; the GUI served on port 0, one render through
    HTTP and a cancel.  Each tool's seconds, B1 and B2 launches, pass flags
    and a short report; ``box`` again with ``--cpu`` from the same
    directions, its impulses bit-equal to the card's and its IR within
    ``BOX_IR_REL`` of peak."""
    import contextlib
    import importlib
    import io
    from wayverb_tpu_torch.core.orientation import random_unit_vectors
    from wayverb_tpu_torch.tools import box as box_tool
    from wayverb_tpu_torch.utils.audio import read_wav
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    from wayverb_tpu_torch.waveguide.box_mega import mega_chunk
    result, ok = {}, True

    def run(name, argv, **kwargs):
        module = importlib.import_module(f"wayverb_tpu_torch.tools.{name}")
        mega_chunk.launches = fused_step.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            report = module.main(argv, **kwargs)
        torch.cuda.synchronize()
        return (report, time.perf_counter() - t0,
                {"box_fused_step": fused_step.launches,
                 "box_mega_chunk": mega_chunk.launches},
                printed.getvalue().splitlines())

    def record(name, secs, launches, flags, shown):
        nonlocal ok
        ok &= all(flags.values())
        print(f"[43 last tools] {name}: {secs:.2f} s, launches {launches}, "
              f"flags {flags}; report {json.dumps(shown)} [{card}]",
              flush=True)
        result[name] = {"seconds": secs, "launches": launches,
                        "flags": flags, "report": shown}

    with tempfile.TemporaryDirectory() as tmp:
        # box: the card, then the CPU from the same directions
        gen = torch.Generator().manual_seed(SEED + 43)
        rays = 1 << 15
        dirs = (random_unit_vectors(rays, gen),
                torch.stack([random_unit_vectors(rays, gen)
                             for _ in range(4)]))
        wavs = {d: os.path.join(tmp, f"box_{d}.wav") for d in ("cuda", "cpu")}
        rep, secs, launches, _ = run("box", ["--out", wavs["cuda"]],
                                     directions=dirs)
        cpu_rep, cpu_secs, _, _ = run("box", ["--cpu", "--out", wavs["cpu"]],
                                      directions=dirs)
        found = {d: box_tool.image_sources(rays, 3, 0.1, torch.device(d),
                                           dirs)[0] for d in ("cuda", "cpu")}
        same = all(torch.equal(getattr(found["cuda"], k).cpu(),
                               getattr(found["cpu"], k))
                   for k in ("volume", "position", "distance"))
        ir_card, ir_cpu = read_wav(wavs["cuda"])[0], read_wav(wavs["cpu"])[0]
        ir_rel = (float(np.abs(ir_card - ir_cpu).max() / np.abs(ir_cpu).max())
                  if ir_card.shape == ir_cpu.shape else float("inf"))
        record("box", secs, launches, {
            "all_on_the_lattice": rep["matched"] == rep["traced_paths"] > 0,
            "wav": _wav_ok(wavs["cuda"]),
            "impulses_card_eq_cpu": same,
            "ir_card_vs_cpu": ir_rel <= BOX_IR_REL}, {
            **{k: rep[k] for k in ("traced_paths", "matched", "ir_samples",
                                   "peak")},
            "impulses": found["cpu"].count, "cpu_seconds": cpu_secs,
            "ir_card_vs_cpu_of_peak": ir_rel})

        rep, secs, launches, _ = run("diffuse_decay", [])
        record("diffuse_decay", secs, launches, {
            "t30_finite": all(0 < b["t30_s"] < float("inf")
                              for b in rep["bands"])}, {
            **rep["setup"],
            "t30_vs_sabine_percent": [round(b["t30_vs_sabine_percent"], 3)
                                      for b in rep["bands"]],
            "decay_rms_deviation_db": [round(b["decay_rms_deviation_db"], 4)
                                       for b in rep["bands"]]})

        rep, secs, launches, _ = run("boundary_fit_sweep", [])
        record("boundary_fit_sweep", secs, launches, {
            "passive": rep["worst_reflectance"] <= 1.0 + 1e-6,
            "fit_within_bound":
                rep["worst_inband_r_error"] <= rep["error_bound"]}, {
            k: rep[k] for k in ("materials", "worst_inband_r_error",
                                "worst_reflectance")} | {
            "fits": len(rep["rows"])})

        rep, secs, launches, printed = run("longrun", [])
        record("longrun hw", secs, launches, {
            "LONGRUN_HW_PASS": printed[-1:] == ["LONGRUN_HW_PASS"],
            "b1_once_a_step": launches["box_fused_step"] == LONGRUN_STEPS,
            "steps": rep["steps"] == LONGRUN_STEPS}, {
            **rep, "ms_per_step": 1e3 * rep["wall_s"] / rep["steps"]})

        rep, secs, launches, printed = run(
            "longrun", ["--mode", "f64", "--steps", str(LONGRUN_F64_STEPS)])
        record("longrun f64", secs, launches, {
            "LONGRUN_F64_PASS": printed[-1:] == ["LONGRUN_F64_PASS"],
            "stable": rep["stable32"] and rep["stable64"]}, rep)

        wav = os.path.join(tmp, "crackly_tunnel.wav")
        rep, secs, launches, _ = run("crackly_tunnel", ["--out", wav])
        record("crackly_tunnel", secs, launches, {
            "wav": _wav_ok(wav), "b2": launches["box_mega_chunk"] > 0,
            "finite": all(math.isfinite(rep[k]) for k in (
                "max_jump_over_envelope", "p999_jump_over_envelope"))},
            {k: v for k, v in rep.items() if k != "wrote"})

        hrirs = os.path.join(tmp, "hrirs")
        os.makedirs(hrirs)
        _synth_hrirs(hrirs)
        table_path = os.path.join(tmp, "table.npz")
        rep, secs, launches, _ = run("bake_hrtf", [hrirs, table_path])
        table = np.load(table_path)["table"]
        mid = table.shape[1] // 2
        record("bake_hrtf", secs, launches, {
            "coverage": rep["baked_bins"] == 36 and table.shape == (24, 9, 2,
                                                                    8),
            "ild": bool(np.all(table[6, mid, 1] > table[6, mid, 0])
                        and np.all(table[18, mid, 0] > table[18, mid, 1]))},
            {k: rep[k] for k in ("baked_bins", "bins")})

        viz = os.path.join(tmp, "viz")
        rep, secs, launches, _ = run("visualize", ["--out-dir", viz])
        sizes = [_png_size(f["path"]) for f in rep["wavefronts"]]
        ray_size = _png_size(rep["rays"]["path"])
        record("visualize", secs, launches, {
            "pngs": all(s is not None and s[0] >= 400 for s in sizes)
            and ray_size == (660, 495),
            "frames": len(sizes) == 8,
            "b1": launches["box_fused_step"] == 48}, {
            "wavefront_png": sizes[0], "ray_png": ray_size,
            "slice_peak": float(np.abs(rep["wavefronts"][-1]["slice"]).max()),
            "polylines": list(rep["rays"]["polylines"].shape)})

        from wayverb_tpu_torch.tools import gui
        mega_chunk.launches = fused_step.launches = 0
        t0 = time.perf_counter()
        rep, flags = _gui_loop(torch, gui, tmp, lambda: {
            "box_fused_step": fused_step.launches,
            "box_mega_chunk": mega_chunk.launches})
        torch.cuda.synchronize()
        record("gui", time.perf_counter() - t0, rep["render_launches"], flags,
               rep)
    print(json.dumps({"phase": "43 last tools", **result}))
    if not ok:
        _fail("one of the last eight tools failed its checks on the card")
    return result


@contextlib.contextmanager
def _phase_wall(label):
    """Prints ``[label] phase wall … s`` when the block ends."""
    t0 = time.perf_counter()
    yield
    print(f"[{label}] phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)


def main():
    if "--rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        _rank_main(int(args["--rank"]), int(args["--world"]),
                   int(args["--port"]), args["--out"])
        return
    import torch
    with _phase_wall("1 device"):
        card = phase_device(torch)
    with _phase_wall("2 build"):
        ptxas = phase_build(card)
    with _phase_wall("5 hall mesh"):
        box, dx, mesh, setup_s = _hall_mesh(torch)
    with _phase_wall("3 B1"):
        b1_err = phase_kernel_vs_plain(torch, mesh.box_spec, card)
    with _phase_wall("4 t30"):
        t30_mesh, t30_fused, sabine, t30_src, t30_rcv = phase_t30(torch,
                                                                  card)
    with _phase_wall("5 hall"):
        fused_out, b1_launches, step_s = phase_hall(torch, box, dx, mesh,
                                                    setup_s, card)
        b1_rows = phase_kernel_time(torch, mesh.box_spec, card)
        hall_window = phase_profile(torch, mesh, box, dx, step_s, card)
    with _phase_wall("6 B2"):
        b2_err, hall_case = phase_mega_vs_plain(torch, mesh, box, dx, card)
    with _phase_wall("7 mega"):
        b2_us, b2_plain_us, b2_occ = phase_mega_time(torch, hall_case, ptxas,
                                                     card)
        phase_mega_hall(torch, box, dx, mesh, fused_out, step_s, card)
    del fused_out
    torch.cuda.empty_cache()
    with _phase_wall("38 resumable hall"):
        resumable = {"hall": phase_resumable_hall(torch, box, dx, mesh,
                                                  card)}
    torch.cuda.empty_cache()

    with _phase_wall("11 B5"):
        b5_err = phase_b5_vs_plain(torch, mesh.box_spec, card)
        b5_time = phase_b5_time(torch, mesh.box_spec, card)
    with _phase_wall("12 grad"):
        b6_err, b7_err, grad_case = phase_grad_chunks_vs_plain(
            torch, mesh, box, dx, card)
        b6_us, b6_plain_us, b7_us, b7_plain_us, theta_us, b7_occ = \
            phase_grad_chunk_time(torch, grad_case, card)
    torch.cuda.empty_cache()
    with _phase_wall("13 grad hall"):
        grad_counts, grad_fwd_s, grad_bwd_s, grad_peak, grad_more = \
            phase_grad_hall(torch, box, dx, mesh, card)
    with _phase_wall("14 routes"):
        route_counts, _ = phase_grad_routes(torch, mesh, card)
    hall_spec, hall_dims = mesh.box_spec, mesh.box_spec.dims
    bounds = kernel_bounds(hall_spec, hall_case[1].shape[1] - 1,
                           hall_case[4].numel())
    # not a bound_ms: the looser reckoning, for the reader of the times above
    print("[12 grad] per sub-step with the fields streamed through device "
          "memory every sub-step (not the bound): "
          + ", ".join(f"{n.upper()} {1e3 * bounds[n + '_stream']:.1f} us "
                      f"(bound {1e3 * bounds[n][0]:.2f} us)"
                      for n in ("b2", "b6", "b7"))
          + f"; B7 in the two-field form (three fields streamed, as the "
          f"kernel runs) {1e3 * bounds['b7_stream_two_field']:.1f} us, in "
          f"the four-field form {1e3 * bounds['b7_stream']:.1f} us",
          flush=True)
    del mesh, hall_case, grad_case
    torch.cuda.empty_cache()

    with _phase_wall("8 t30 mega"):
        phase_t30_mega(torch, t30_mesh, t30_fused, sabine, t30_src, t30_rcv,
                       card)
    with _phase_wall("9 hybrid"):
        launches, engine_dims, b2_engine_err = phase_hybrid_hall(
            torch, hall_spec, card)
    with _phase_wall("10 hybrid"):
        phase_hybrid_card_vs_cpu(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("36 multiband hall"):
        multiband = phase_multiband_hall(torch, card)
    with _phase_wall("37 multiband card vs cpu"):
        multiband["card_vs_cpu"] = phase_multiband_card_vs_cpu(torch, card)
    with _phase_wall("15 card vs cpu"):
        phase_grad_card_vs_cpu(torch, card)
    with _phase_wall("16 descent"):
        phase_descent(torch, card)
    torch.cuda.empty_cache()

    col_timings = {}
    with _phase_wall("19 columns mesh"):
        t0 = time.perf_counter()
        col_mesh = _columns_mesh(torch, COLUMNS_CUTOFF, "cuda", col_timings)
        col_setup_s = time.perf_counter() - t0
    col_dims = list(col_mesh.descriptor.dimensions)
    with _phase_wall("17 mesh"):
        b8_err, b9_err, b12_err = phase_mesh_kernels_vs_plain(
            torch, col_mesh.structure, card)
    with _phase_wall("18 mesh"):
        mesh_times, mesh_bounds, b9_occ = phase_mesh_kernel_times(
            torch, col_mesh.structure, card)
    torch.cuda.empty_cache()
    with _phase_wall("19 columns"):
        columns = phase_columns_hall(torch, col_mesh, col_timings,
                                     col_setup_s, card)
    with _phase_wall("20 t30 general"):
        thin_launches, thin_err = phase_general_physics(
            torch, t30_mesh, t30_src, t30_rcv, sabine, card)
    b12_err = max(b12_err, thin_err)
    with _phase_wall("21 hybrid columns"):
        col_launches, hybrid_columns = phase_hybrid_columns(
            torch, col_mesh.structure.weight_code, card)
        phase_hybrid_columns_card_vs_cpu(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("22 general grad"):
        general_grad_counts, general_grad = phase_general_gradient(
            torch, col_mesh, card)
        phase_general_grad_card_vs_cpu(torch, card)
    with _phase_wall("39 resumable columns"):
        resumable["general"] = phase_resumable_general(torch, col_mesh, card)
    del col_mesh
    torch.cuda.empty_cache()

    from wayverb_tpu_torch.raytracer import mt_kernels as mk
    from wayverb_tpu_torch.raytracer.scenes import (procedural_hall,
                                                    procedural_hall_large)
    with _phase_wall("23 mt"):
        (model_cpu, n_model), (large_cpu, n_large) = procedural_hall(), \
            procedural_hall_large()
        if (n_model, n_large) != (5448, 97068):
            _fail(f"the halls have {n_model} and {n_large} triangles, "
                  "expected 5448 and 97068")
        model_soup, large_soup = model_cpu.to("cuda"), large_cpu.to("cuda")
        model_tris = mk.build_mt_triangles(model_cpu).to("cuda")
        large_tris = mk.build_mt_triangles(large_cpu).to("cuda")
        large_plain_tris = mk.build_mt_triangles(large_cpu,
                                                 cull=False).to("cuda")
        if model_tris.culled or not large_tris.culled:
            _fail("build_mt_triangles culls the model hall or not the large "
                  "one")
        b3_err, b4_err = phase_mt_vs_plain(torch, model_tris, large_tris,
                                           card)
    with _phase_wall("24 mt"):
        mt_times = phase_mt_times(torch, model_soup, model_tris, large_soup,
                                  large_tris, large_plain_tris, card)
    with _phase_wall("25 model hall"):
        model_launches, model_hall = phase_model_hall(torch, model_cpu, card)
    torch.cuda.empty_cache()
    with _phase_wall("26 large hall"):
        large_launches, large_hall = phase_large_hall(
            torch, large_soup, large_tris, large_plain_tris, card)
    with _phase_wall("27 dda"):
        dda = phase_dda_on_card(torch, model_soup, model_tris, card)
    torch.cuda.empty_cache()
    with _phase_wall("28 card vs cpu"):
        phase_hall_card_vs_cpu(torch, card)
    del model_soup, large_soup, model_tris, large_tris, large_plain_tris
    torch.cuda.empty_cache()

    with _phase_wall("29 sharded"):
        sharded_engine, sharded_setup = _sharded_columns_engine(torch, card)
        shard_mesh = sharded_engine.mesh
        shard_errs, shard_times, shard_bounds, shard_occ = phase_shard_kernels(
            torch, shard_mesh.structure, card)
    with _phase_wall("30 sharded general"):
        sharded_general = phase_general_sharded(torch, shard_mesh, card)
    with _phase_wall("31 sharded grad"):
        shard_grad_counts, sharded_grad = phase_general_sharded_gradient(
            torch, shard_mesh, card)
    torch.cuda.empty_cache()
    with _phase_wall("32 sharded engine"):
        shard_launches, sharded_engine_run, engine_ref = phase_sharded_engine(
            torch, sharded_engine, sharded_setup, card)
    with _phase_wall("41 distributed"):
        distributed = phase_distributed(torch, sharded_engine, engine_ref,
                                        card)
    del engine_ref
    shard_dims = [shard_mesh.descriptor.dimensions[0] // SHARDS,
                  *shard_mesh.descriptor.dimensions[1:]]
    del sharded_engine, shard_mesh
    torch.cuda.empty_cache()
    with _phase_wall("33 box sharded"):
        box_sharded = phase_box_sharded(torch, card)
    with _phase_wall("34 sharded trace"):
        phase_sharded_trace(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("35 probe"):
        probe = phase_probe(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("44 mega check"):
        mega_check = phase_mega_check(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("39 resumable thin"):
        resumable["thin"] = phase_resumable_thin(torch, card)
    with _phase_wall("40 project"):
        project = phase_project(torch, card)
    with _phase_wall("42 tools"):
        tools = phase_tools(torch, card)
    torch.cuda.empty_cache()
    with _phase_wall("43 last tools"):
        last_tools = phase_last_tools(torch, card)
    dist_launches = distributed["distributed_launches"]
    counted = {"box_fused_step": b1_launches,
               "box_mega_chunk": launches["box_mega_chunk"],
               "box_fused_step_bwd": route_counts["box_fused_step_bwd"],
               "box_mega_chunk_grad": grad_counts["box_mega_chunk_grad"],
               "box_mega_chunk_bwd": grad_counts["box_mega_chunk_bwd"],
               "mesh_weighted_step": col_launches["mesh_weighted_step"],
               "mesh_weighted_step_bwd":
                   general_grad_counts["mesh_weighted_step_bwd"],
               "mesh_interior_step": thin_launches,
               "ray_mt_closest": model_launches["ray_mt_closest"],
               "ray_mt_closest_culled":
                   large_launches["ray_mt_closest_culled"],
               "mesh_weighted_step_haloed":
                   shard_launches["mesh_weighted_step_haloed"],
               "mesh_weighted_step_haloed_bwd":
                   shard_grad_counts["mesh_weighted_step_haloed_bwd"],
               "probe_resident": probe["launches"]}
    if not all(counted.values()):
        _fail(f"a kernel of a path was not launched: {counted}")

    def per_substep(name, launch_us, plain_launch_us):
        return {"ms": launch_us / CHUNK / 1e3,
                "plain_ms": plain_launch_us / CHUNK / 1e3,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": None,
                "ms_is_per": "sub-step (a launch runs K of them)",
                "launch_ms": launch_us / 1e3,
                "plain_launch_ms": plain_launch_us / 1e3}

    print(json.dumps({"kernels": [{
        "name": "box_fused_step",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_fused_step.cu",
        "replaces": "wayverb_tpu/waveguide/box_fused.py:400",
        "shape": list(hall_dims),
        "launches": counted["box_fused_step"],
        "max_abs_err": b1_err,
        "ms": b1_rows["hall"]["us_per_step"] / 1e3,
        "plain_ms": b1_rows["hall"]["plain_us_per_step"] / 1e3,
        "bound_ms": b1_rows["hall"]["bound_us"] / 1e3,
        "bound_by": b1_rows["hall"]["bound_by"],
        "library_ms": None,
        "ms_is_per": "step",
        "host_ms_per_call": b1_rows["hall"]["host_us_per_call"] / 1e3,
        **{k: b1_rows["hall"]["occupancy"][k]
           for k in ("registers", "local_bytes", "ctas_per_sm")},
        "resumable_launches": resumable["hall"]["b1_launches"],
        "distributed_launches": dist_launches["box_fused_step"],
        "tool_launches": {
            name: last_tools[name]["launches"]["box_fused_step"]
            for name in ("longrun hw", "longrun f64", "visualize", "gui")},
        "hall_run": {"wall_ms_per_step": 1e3 * step_s,
                     "busy_ms_per_step": (hall_window[0] / 1e3
                                          if hall_window else None),
                     "idle_share": hall_window[2] if hall_window else None},
        "shard": {"shape": b1_rows["shard"]["shape"], "halos": True,
                  "ms": b1_rows["shard"]["us_per_step"] / 1e3,
                  "bound_ms": b1_rows["shard"]["bound_us"] / 1e3,
                  "host_ms_per_call":
                      b1_rows["shard"]["host_us_per_call"] / 1e3},
    }, {
        "name": f"box_mega_chunk (K={CHUNK})",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_mega_chunk.cu",
        "replaces": "wayverb_tpu/waveguide/box_mega.py:534",
        "shape": list(engine_dims),
        "launches": counted["box_mega_chunk"],
        "multiband_launches": multiband["launches"]["box_mega_chunk"],
        "project_launches": project["b2_launches"],
        "tool_launches": {
            name: last_tools[name]["launches"]["box_mega_chunk"]
            for name in ("crackly_tunnel", "gui")},
        "max_abs_err": max(b2_err, b2_engine_err),
        **per_substep("b2", b2_us, b2_plain_us),
        **{k: b2_occ[k] for k in ("registers", "local_bytes", "ctas_per_sm")},
    }, {
        "name": "box_fused_step_bwd",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_fused_step_bwd.cu",
        "replaces": "wayverb_tpu/waveguide/box_fused.py:548",
        "shape": list(hall_dims),
        "launches": counted["box_fused_step_bwd"],
        "max_abs_err": b5_err,
        "bits_equal": True,
        "err_is": "every output to the bit (NaN for NaN, -0 apart from +0) "
                  "in all nine cases of phase 11, or the phase fails",
        "ms": b5_time["us"] / 1e3,
        "plain_ms": b5_time["plain_us"] / 1e3,
        "bound_ms": bounds["b5"][0], "bound_by": bounds["b5"][1],
        "library_ms": None,
        "ms_is_per": "step",
        "host_ms_per_call": b5_time["host_us"] / 1e3,
        **{k: b5_time["occupancy"][k]
           for k in ("registers", "local_bytes", "ctas_per_sm")},
        "warp_shares": b5_time["warp_shares"],
        "distributed_launches": dist_launches["box_fused_step_bwd"],
        "shard": {k: box_sharded["b5_shard"][k]
                  for k in ("shape", "ms", "host_ms", "bound_ms")},
    }, {
        "name": f"box_mega_chunk grad mode (K={CHUNK})",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_mega_chunk.cu",
        "replaces": "wayverb_tpu/waveguide/box_mega.py:534",
        "shape": list(hall_dims),
        "launches": counted["box_mega_chunk_grad"],
        "max_abs_err": b6_err,
        "err_is": "residuals; the forward outputs equal the plain chunk "
                  "kernel's to the bit",
        **per_substep("b6", b6_us, b6_plain_us),
        **{k: b2_occ[k] for k in ("registers", "local_bytes", "ctas_per_sm")},
    }, {
        "name": f"box_mega_chunk_bwd (K={CHUNK})",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_mega_chunk_bwd.cu",
        "replaces": "wayverb_tpu/waveguide/box_mega.py:882",
        "shape": list(hall_dims),
        "launches": counted["box_mega_chunk_bwd"],
        "max_abs_err": b7_err,
        "err_is": f"worst of six outputs; each is gated at {BWD_REL:g} of "
                  "its own largest value",
        **per_substep("b7", b7_us, b7_plain_us),
        **{k: b7_occ[k] for k in ("registers", "local_bytes", "ctas_per_sm")},
    }, *({
        "name": name,
        "route": "cuda",
        "source": f"wayverb_tpu_torch/csrc/{name}.cu",
        "replaces": f"wayverb_tpu/waveguide/stencil_pallas.py:{line}",
        "shape": shape,
        "launches": counted[name],
        "max_abs_err": err,
        "ms": mesh_times[key][0] / 1e3,
        "plain_ms": mesh_times[key][1] / 1e3,
        "bound_ms": mesh_bounds[key][0], "bound_by": mesh_bounds[key][1],
        "library_ms": None,
        "ms_is_per": "step",
        "launches_on": on,
        **extra,
    } for name, key, line, err, shape, on, extra in (
        ("mesh_weighted_step", "b8", 172, b8_err, col_dims,
         "Engine.run on the columns hall",
         {"resumable_launches": resumable["general"]["launches"]}),
        ("mesh_weighted_step_bwd", "b9", 195, b9_err, col_dims,
         "the columns hall's 64-step gradient",
         {**{k: b9_occ[k] for k in ("registers", "local_bytes",
                                    "ctas_per_sm", "bare_warp_share")},
          "backward_device_ms": (
              general_grad["profile"]["b9_backward"]["device_us"] / 1e3
              if general_grad["profile"] else None)}),
        ("mesh_interior_step", "b12", 35, b12_err, col_dims,
         "canonical on the thin box (the region path); timed at the "
         "columns hall's shape",
         {"resumable_launches": resumable["thin"]["launches"]}))), *({
        "name": name,
        "route": "cuda",
        "source": f"wayverb_tpu_torch/csrc/{name}.cu",
        "replaces": f"wayverb_tpu/raytracer/mt_pallas.py:{line}",
        "shape": mt_times[key]["shape"],
        "launches": counted[name],
        "max_abs_err": err,
        "ms": mt_times[key]["us"] / 1e3,
        "plain_ms": mt_times[key]["plain_us"] / 1e3,
        "bound_ms": mt_times[key]["bound"][0],
        "bound_by": mt_times[key]["bound"][1],
        "library_ms": None,
        "ms_is_per": "launch",
        "launches_on": on,
        **extra,
    } for name, key, line, err, on, extra in (
        ("ray_mt_closest", "b3", 192,
         max(b3_err, mt_times["b3"]["max_abs_err"],
             mt_times["b3_large"]["max_abs_err"]),
         "Engine.run on the model hall (two launches a bounce)",
         {"late_ms": mt_times["b3"]["late_us"] / 1e3,
          **{k: mt_times["b3"]["occupancy"][k]
             for k in ("registers", "local_bytes", "ctas_per_sm",
                       "clusters")},
          "skip_shares": mt_times["b3"]["skip_shares"],
          "large_hall": {
              "shape": mt_times["b3_large"]["shape"],
              "ms": mt_times["b3_large"]["us"] / 1e3,
              "late_ms": mt_times["b3_large"]["late_us"] / 1e3,
              "plain_ms": mt_times["b3_large"]["plain_us"] / 1e3,
              "bound_ms": mt_times["b3_large"]["bound"][0],
              "skip_shares": mt_times["b3_large"]["skip_shares"]}}),
        ("ray_mt_closest_culled", "b4", 203,
         max(b4_err, mt_times["b4"]["max_abs_err"]),
         "trace on the large hall (two launches a bounce)",
         {"tile_pairs_run": mt_times["b4"]["tile_pairs_run"],
          "tiles_per_ray_tile": {
              k: mt_times["b4"]["tile_stats"][k]
              for k in ("max", "mean", "min")},
          "registers": mt_times["b4"]["occupancy"]["registers"],
          "ctas_per_sm": mt_times["b4"]["occupancy"]["ctas_per_sm"],
          "all_pairs_kernel_ms": mt_times["b3_large"]["us"] / 1e3}))), *({
        "name": name,
        "route": "cuda",
        "source": f"wayverb_tpu_torch/csrc/{name}.cu",
        "replaces": f"wayverb_tpu/waveguide/stencil_pallas.py:{line}",
        "shape": shard_dims,
        "launches": counted[name],
        "max_abs_err": err,
        "ms": shard_times[key][0] / 1e3,
        "plain_ms": shard_times[key][1] / 1e3,
        "bound_ms": shard_bounds[key][0], "bound_by": shard_bounds[key][1],
        "library_ms": None,
        "ms_is_per": "launch (one shard's step)",
        "launches_on": on,
        "distributed_launches": dist_launches[name],
        **extra,
    } for name, key, line, err, on, extra in (
        ("mesh_weighted_step_haloed", "b10", 366, shard_errs[0],
         f"Engine(device_mesh={SHARDS} x cuda:0).run on the columns hall",
         {**{k: shard_occ["b10"][k] for k in ("registers", "local_bytes",
                                              "ctas_per_sm",
                                              "bare_warp_share")},
          "us": shard_times["b10"][0],
          "bound_us": 1e3 * shard_bounds["b10"][0],
          "time_over_bound": shard_times["b10"][0]
          / (1e3 * shard_bounds["b10"][0]),
          "profiled_us_per_launch": (
              sharded_general["profile"]["b10_us_per_step"] / SHARDS
              if sharded_general["profile"]
              and sharded_general["profile"]["b10_us_per_step"] is not None
              else None)}),
        ("mesh_weighted_step_haloed_bwd", "b11", 396, shard_errs[1],
         "the columns hall's 32-step gradient on 4 shards",
         {**{k: shard_occ["b11"][k] for k in ("registers", "local_bytes",
                                              "ctas_per_sm",
                                              "bare_warp_share")},
          "backward_device_ms": (sharded_grad["b11_device_us"] / 1e3
                                 if sharded_grad["b11_device_us"]
                                 is not None else None)}))), {
        "name": f"probe_resident (K={PROBE_LINE[1]})",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/probe_resident.cu",
        "replaces": "tools/bench/probe_vmem_resident.py:54",
        "shape": list(PROBE_LINE[0]),
        "mode": "resident",
        "tiles": probe["row"]["tiles"],
        "bytes_per_cta": probe["row"]["bytes_per_cta"],
        **{k: probe["occupancy"]["resident"][k]
           for k in ("registers", "local_bytes", "ctas_per_sm", "cluster",
                     "clusters", "threads", "form")},
        "one_cluster_occupancy": probe["occupancy"]["one_cluster"],
        "device_memory_occupancy": probe["occupancy"]["device_memory"],
        "launches": counted["probe_resident"],
        "max_abs_err": probe["max_abs_err"],
        "ms": probe["row"]["us_per_step"] / 1e3,
        "plain_ms": probe["plain_us"] / 1e3,
        "bound_ms": probe["row"]["bound_us"] / 1e3,
        "bound_by": probe["row"]["bound_by"],
        "library_ms": None,
        "library_none_because": "conv3d gives only the neighbour sum, not "
                                "C2 * sum - dst",
        "ms_is_per": "sub-step (a launch runs K of them)",
        "launches_on": "the sweep of python -m "
                       "wayverb_tpu_torch.tools.probe_resident",
        "device_memory_shape": list(PROBE_STREAMED),
        "device_memory_ctas": probe["streamed"]["tiles"],
        "device_memory_ms": probe["streamed"]["us_per_step"] / 1e3,
        "device_memory_bound_ms": probe["streamed"]["bound_us"] / 1e3,
        "sweep_s": probe["sweep_s"]}],
        "multiband_hall": multiband, "resumable": resumable,
        "mega_check": mega_check,
        "project": project,
        "model_hall": model_hall, "large_hall": large_hall,
        "dda_on_card": dda, "columns_hall": columns,
        "hybrid_columns_hall": hybrid_columns,
        "general_gradient": general_grad,
        "sharded_general": sharded_general, "sharded_gradient": sharded_grad,
        "sharded_engine": sharded_engine_run, "box_sharded": box_sharded,
        "distributed": distributed, "tools": tools,
        "last_tools": last_tools,
        "gradient_path": {
        "shape": list(hall_dims), "steps": GRAD_STEPS, "chunk": CHUNK,
        "forward_s": grad_fwd_s, "backward_s": grad_bwd_s,
        "theta_grads_ms_per_chunk": theta_us / 1e3,
        "peak_memory_bytes": grad_peak, **grad_more}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
