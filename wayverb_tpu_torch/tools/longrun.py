"""Long-run stability validation (the reference's ``tools/longrun.py``, the
``nan_in_waveguide.cpp`` analogue).

Two modes:
  --mode hw   : at least 10^4 steps at the production bench shape
                (224, 224, 256) through ``run_waveguide_box``, the fused
                route (one B1 launch a step on the card); asserts the run
                stays stable (finite boundary planes every step and a finite
                field at the end) and prints tail statistics.
  --mode f64  : a 32 x 32 x 128 run with float32 fields, its IIR filter
                state in float32 and in float64; prints the receiver
                trace's drift, the check behind float32 state by default
                where the reference C++ keeps double
                (cl/filter_structs.h:14).  The reference pins this mode to
                the CPU; the port runs it where ``--cpu`` says.  The
                reference builds its mesh after switching x64 on, which
                rounds the box's corners in float64 and gives (31, 31, 128);
                ``build`` gives (32, 32, 128) here, as the reference's does
                without x64.

    python -m wayverb_tpu_torch.tools.longrun [--mode hw|f64] [--steps N]
        [--json PATH] [--cpu]

``--json`` appends the record to the file the caller names.  ``main``
returns the record.
"""

import argparse
import json
import os
import time

import numpy as np
import torch


def build(side, steps, absorption=0.08, *, device):
    """(mesh, source, receiver): a shoebox of ``side`` nodes at 3333.33 Hz,
    a hard impulse at the centre, the receiver six nodes above it."""
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
    from wayverb_tpu_torch.waveguide.sources import (
        HardSource, impulse_signal, rectilinear_calibration_factor)

    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    box = Box((0, 0, 0), (dx * (side[0] - 4), dx * (side[1] - 4),
                          dx * (side[2] - 4)))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), absorption), dx, fs,
                              device=device)
    desc = mesh.descriptor
    centre = tuple(box.centre().numpy())
    src = mesh.require_inside(centre)
    rcv = mesh.require_inside(
        tuple(np.asarray(centre) + np.asarray([0.0, 0.0, dx * 6])))
    amp = rectilinear_calibration_factor(dx, 400.0)
    source = HardSource(node_idx=desc.flat_index(src),
                        signal=impulse_signal(steps, amp, device))
    receiver = NodeReceiver(node_idx=torch.tensor(desc.flat_index(rcv),
                                                  device=device))
    return mesh, source, receiver


def mode_hw(steps, *, device):
    from wayverb_tpu_torch.waveguide.run import run_waveguide_box

    mesh, source, receiver = build((224, 224, 256), steps, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    out = run_waveguide_box(mesh.structure, mesh.box_spec, source, receiver,
                            steps)
    p = out["outputs"]
    stable, peak, tail_peak, energy = [float(v) for v in (
        out["stable"].to(torch.float32), torch.max(torch.abs(p)),
        torch.max(torch.abs(p[-steps // 10:])), torch.sum(p ** 2))]
    dt = time.time() - t0
    print(f"steps={steps} wall={dt:.1f}s stable={stable} peak={peak:.4e} "
          f"tail_peak={tail_peak:.4e} energy={energy:.4e}")
    assert stable == 1.0, "long run went unstable"
    assert tail_peak < peak, "no decay?"
    print("LONGRUN_HW_PASS")
    return {"mode": "hw", "steps": steps, "shape": [224, 224, 256],
            "wall_s": dt, "stable": stable, "peak": peak,
            "tail_peak": tail_peak, "energy": energy}


def mode_f64(steps, *, device):
    from wayverb_tpu_torch.waveguide.run import run_waveguide_box

    mesh, source, receiver = build((32, 32, 128), steps, absorption=0.05,
                                   device=device)
    o32 = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                            receiver, steps)
    o64 = run_waveguide_box(mesh.structure, mesh.box_spec, source,
                            receiver, steps, state_dtype=torch.float64)
    p32 = o32["outputs"].cpu().numpy()
    p64 = o64["outputs"].cpu().numpy()
    stable32, stable64 = bool(o32["stable"]), bool(o64["stable"])
    scale = np.abs(p64).max()
    drift = np.abs(p32 - p64).max()
    print(f"steps={steps} stable32={stable32} "
          f"stable64={stable64} peak={scale:.4e} "
          f"max_drift={drift:.4e} rel={drift/scale:.2e}")
    assert stable32 and stable64
    assert drift / scale < 2e-3, "f32 filter state drifted beyond bound"
    print("LONGRUN_F64_PASS")
    return {"mode": "f64", "steps": steps, "shape": [32, 32, 128],
            "peak": float(scale), "max_drift": float(drift),
            "rel_drift": float(drift / scale), "bound": 2e-3,
            "stable32": stable32, "stable64": stable64}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["hw", "f64"], default="hw")
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--json", type=str, default=None,
                    help="append the result record to this JSON file")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.tools._cli import device_for

    device = device_for(args.cpu)
    rec = mode_hw(args.steps, device=device) if args.mode == "hw" else \
        mode_f64(args.steps, device=device)
    if args.json:
        data = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                data = json.load(f)
        data = [d for d in data if d.get("mode") != rec["mode"]]
        data.append(rec)
        with open(args.json, "w") as f:
            json.dump(data, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
