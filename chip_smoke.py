#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``wayverb_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's waveguide leg through its public entry points on the card
and fails (non-zero exit, no result line) on any error:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the path from ``wayverb_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA tensors;
4. T30 oracle: ``canonical`` on a 2.0×2.5×3.0 m box against Sabine, against
   the port's plain CPU run of the same case, then ``postprocess``;
5. a concert-hall shoebox of 12.8 M nodes for 1024 steps, with the kernel
   launch count, step time, node-update rate, kernel time and peak memory,
   and a profiler breakdown of where a step's time goes;
6. one JSON line of per-kernel results, then the last line,
   ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 3333.33                # mesh rate of a 500 Hz waveguide cutoff
ABSORPTION = 0.1
SEED = 20261016
KERNEL_ATOL = 1e-5          # test_box_fused.py bound on the Pallas kernel


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
    from wayverb_tpu_torch import _build
    t0 = time.perf_counter()
    lib, log = _build.build("box_fused_step", force=True)
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] box_fused_step.cu → {os.path.relpath(lib, ROOT)} in "
          f"{dt:.2f} s (nvcc, sm_90a); ptxas: {' | '.join(ptxas)} "
          f"[{card}]")


def _random_step_inputs(torch, spec, x_offset, gen, halos=True):
    from wayverb_tpu_torch.waveguide.box_fused import _plane_shapes
    X, Y, Z = spec.dims
    X -= x_offset
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
    cur, prev = rnd(X, Y, Z), rnd(X, Y, Z)
    planes = tuple(rnd(*s) for s in _plane_shapes(X, Y, Z))
    hal = (rnd(1, Y, Z), rnd(1, Y, Z)) if halos else None
    return cur, prev, planes, hal


def _max_err(a, b):
    (na, ia), (nb, ib) = a, b
    errs = [float((na - nb).abs().max())]
    errs += [float((p - q).abs().max()) for p, q in zip(ia, ib)]
    return max(errs)


def phase_kernel_vs_plain(torch, hall_spec, card):
    """fused_step (CUDA kernel) against _fused_step_plain, same tensors."""
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
    # (spec, x offset, source (global x, y, z), mode, what it checks)
    cases = [
        (s16, 0, (8, 9, 64), 0, "no injection"),
        (s16, 0, (8, 9, 64), 1, "hard source deep inside"),
        (s16, 0, (2, 9, 64), 2, "soft source on the inner x plane"),
        # y = 4 starts a 2-row thread block: its y-1 read crosses blocks
        (s16, 0, (9, 4, 125), 1, "source at a thread-block edge"),
        (s16x, 4, (10, 7, 40), 1, "x offset 4, halos, source in shard"),
        (s37, 0, (18, 14, 26), 2, "unaligned 37x29x53"),
        (hall_spec, 0, (hx // 2, hy // 2, hz // 2), 1, "hall shape"),
    ]
    worst = 0.0
    for spec, xo, src, mode, what in cases:
        cur, prev, planes, halos = _random_step_inputs(torch, spec, xo, gen)
        geom = spec.geom_array(x_offset=xo)
        inj_val = torch.randn(2, generator=gen, device="cuda")
        args = (geom, cur, prev, planes, src + (mode,), inj_val, halos)
        got = fused_step(*args)
        want = _fused_step_plain(*args)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        worst = max(worst, err)
        print(f"[3 kernel] {tuple(cur.shape)} mode {mode} ({what}): "
              f"max |kernel - plain| = {err:.3e} (bound {KERNEL_ATOL:g})")
        if not err <= KERNEL_ATOL:
            _fail(f"kernel disagrees with its plain version: {err}")
    return worst


def phase_t30(torch, card):
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.signal.filters import decay_time
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_cutoff_frequency, grid_spacing)
    from wayverb_tpu_torch.waveguide.postprocess import (BandpassBand,
                                                         postprocess)
    env = Environment()
    dx = grid_spacing(env.speed_of_sound, 1.0 / FS)
    box = Box((0, 0, 0), (2.0, 2.5, 3.0))
    d = np.asarray(box.max_corner)
    sabine = 0.161 * np.prod(d) / (
        2 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]) * ABSORPTION)
    src, rcv = tuple(d * 0.35), tuple(d * 0.65)
    absorption = np.full((1, 8), ABSORPTION)

    mesh = wgrun.shoebox_mesh(box, absorption, dx, FS, device="cuda")
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, src, rcv, 2.0, env)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    steps = out.pressure.shape[0]
    if not bool(out.stable):
        _fail("T30 run unstable on the card")
    t30 = float(decay_time(out.pressure, out.sample_rate, -5, -35))
    rel = abs(t30 - sabine) / sabine
    print(f"[4 t30] {mesh.descriptor.dimensions} grid, {steps} steps on the "
          f"card in {t_gpu:.2f} s ({1e3 * t_gpu / steps:.4f} ms/step, first "
          f"run on the card): T30 {t30:.4f} s vs Sabine {sabine:.4f} s "
          f"({100 * rel:.2f}% off, bound 5%) [{card}]")
    if not rel < 0.05:
        _fail(f"T30 {t30} is {100 * rel:.2f}% from Sabine {sabine}")

    mesh_cpu = wgrun.shoebox_mesh(box, absorption, dx, FS, device="cpu")
    t0 = time.perf_counter()
    out_cpu = wgrun.canonical(mesh_cpu, src, rcv, 2.0, env)
    t_cpu = time.perf_counter() - t0
    p_gpu = out.pressure.cpu()
    peak = float(out_cpu.pressure.abs().max())
    err = float((p_gpu - out_cpu.pressure).abs().max())
    print(f"[4 t30] card vs plain CPU run: max |Δp| = {err:.3e}, bound "
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


def _hall_mesh(torch):
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    side = (224, 224, 256)     # bench.py's production-scale shoebox
    dx = grid_spacing(340.0, 1.0 / FS)
    box = Box((0, 0, 0), tuple(dx * (s - 4) for s in side))
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


def phase_hall(torch, box, dx, mesh, setup_s, card):
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.box_fused import fused_step
    steps = 1024
    desc = mesh.descriptor
    nodes = desc.num_nodes
    fs = desc.sample_rate(340.0)
    sim_time = (steps - 0.5) / fs
    if math.ceil(fs * sim_time) != steps:
        _fail("hall simulation time does not give 1024 steps")
    src, rcv = _hall_positions(box, dx)
    print(f"[5 hall] {desc.dimensions} = {nodes} nodes, mesh setup "
          f"{setup_s:.2f} s on the host")

    wgrun.canonical(mesh, src, rcv, 16 / fs)        # warm-up, 16 steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_step.launches = 0
    t0 = time.perf_counter()
    out = wgrun.canonical(mesh, src, rcv, sim_time)
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
    print(f"[5 hall] wall {1e3 * wall / steps:.4f} ms/step, "
          f"{nodes * steps / wall:.4e} node-updates/s, peak memory "
          f"{peak_mem / 2**20:.1f} MiB [{card}]")
    return launches, wall / steps


def phase_kernel_time(torch, spec, card):
    """Kernel alone vs its plain version at the hall shape (CUDA events)."""
    from wayverb_tpu_torch.waveguide.box_fused import (_fused_step_plain,
                                                       fused_step)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cur, prev, planes, _ = _random_step_inputs(torch, spec, 0, gen,
                                               halos=False)
    geom = spec.geom_array()
    inj = tuple(d // 2 for d in spec.dims) + (1,)
    inj_val = torch.randn(2, generator=gen, device="cuda")
    out = torch.empty_like(cur)
    k_us = _cuda_time_us(torch, lambda: fused_step(
        geom, cur, prev, planes, inj, inj_val, out=out), 200)
    p_us = _cuda_time_us(torch, lambda: _fused_step_plain(
        geom, cur, prev, planes, inj, inj_val), 20)
    nodes = cur.numel()
    print(f"[5 hall] fused step alone at {tuple(cur.shape)}: kernel "
          f"{k_us:.2f} us/step ({12 * nodes / k_us / 1e3:.1f} GB/s at "
          f"12 B/node), plain version {p_us:.2f} us/step [{card}]")
    return k_us, p_us


def phase_profile(torch, mesh, box, dx, step_s, card):
    """Where a step's time goes: a profiled 32-step window of the hall.

    ``step_s``: the unprofiled wall time per step of the 1024-step run; the
    profiler's own overhead inflates the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    from wayverb_tpu_torch.waveguide import run as wgrun
    steps = 32
    fs = mesh.descriptor.sample_rate(340.0)
    src, rcv = _hall_positions(box, dx)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wgrun.canonical(mesh, src, rcv, (steps - 0.5) / fs)
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
        print(f"[5 profile] device time not measured: the profiler saw no "
              f"device activity (wall {wall_us / steps:.1f} us/step)")
        return
    busy_step_us = busy_us / steps
    print(f"[5 profile] {steps} profiled steps: wall {wall_us / steps:.1f} "
          f"us/step (profiler on), device busy {busy_step_us:.1f} us/step, "
          f"{n_kernels / steps:.1f} device kernels/step; idle share "
          f"{1 - busy_us / wall_us:.3f} of the profiled wall, "
          f"{1 - busy_step_us / (1e6 * step_s):.3f} of the unprofiled "
          f"{1e6 * step_s:.1f} us/step [{card}]")
    for t, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[5 profile]   {t / steps:9.2f} us/step  {count / steps:6.2f}"
              f"/step  {key[:90]}")


def main():
    import torch
    card = phase_device(torch)
    phase_build(card)
    box, dx, mesh, setup_s = _hall_mesh(torch)
    worst = phase_kernel_vs_plain(torch, mesh.box_spec, card)
    phase_t30(torch, card)
    launches, step_s = phase_hall(torch, box, dx, mesh, setup_s, card)
    k_us, p_us = phase_kernel_time(torch, mesh.box_spec, card)
    phase_profile(torch, mesh, box, dx, step_s, card)
    print(json.dumps({"kernels": [{
        "name": "box_fused_step",
        "route": "cuda",
        "source": "wayverb_tpu_torch/csrc/box_fused_step.cu",
        "replaces": "wayverb_tpu/waveguide/box_fused.py:400",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_us / 1e3,
        "plain_ms": p_us / 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
