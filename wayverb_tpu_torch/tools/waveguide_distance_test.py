"""1/r pressure decay of the waveguide mesh (the reference's
``tools/waveguide_distance_test.py``, after wayverb's
bin/waveguide_distance_test, which probes mesh propagation with a line of
receivers).  Default mode: free field — a cube large enough that each
receiver's direct arrival is windowed off before the first wall
reflection, so peak |p|·r should be constant.  ``--duct`` reproduces the
reference's 1×1×12 m reflective duct (guided wave, for inspection only).
Prints CSV distance_m, peak, peak·r, then one JSON line.

    python -m wayverb_tpu_torch.tools.waveguide_distance_test [--cpu]
"""

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sample-rate", type=float, default=5000.0)
    ap.add_argument("--max-distance", type=float, default=4.0)
    ap.add_argument("--duct", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.receivers import MultiNodeReceiver
    from wayverb_tpu_torch.waveguide.sources import (
        HardSource, impulse_signal, rectilinear_calibration_factor)

    device = device_for(args.cpu)
    env = Environment()
    c = env.speed_of_sound
    fs = args.sample_rate
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)

    if args.duct:
        box = Box((0, 0, 0), (1.0, 1.0, 12.0))
        source = np.array([0.5, 0.5, 0.5])
        distances = np.arange(1.0, 11.0)
        absorption = 0.0
        sim_time = 1.2 * 12.0 / c
    else:
        # cube with L > 2·max_d + clearance: direct arrival at distance d
        # can be windowed before the earliest reflection (path L − d)
        side = 2.0 * args.max_distance + 2.0
        box = Box((0, 0, 0), (side, side, side))
        source = np.full(3, side / 2)
        distances = np.arange(1.0, args.max_distance + 0.5)
        absorption = 0.5
        sim_time = (args.max_distance + 1.5) / c

    mesh = wgrun.shoebox_mesh(
        box, np.full((1, 8), max(absorption, 1e-3)), dx, fs, device=device)
    desc = mesh.descriptor
    src_loc = mesh.require_inside(tuple(source))
    rcv_locs = [mesh.require_inside(tuple(source + [0, 0, d]))
                for d in distances]
    rcv_idx = torch.as_tensor([desc.flat_index(loc) for loc in rcv_locs],
                              dtype=torch.int64, device=device)

    num_steps = int(sim_time * fs)
    amp = rectilinear_calibration_factor(desc.spacing,
                                         env.acoustic_impedance)
    src = HardSource(node_idx=int(desc.flat_index(src_loc)),
                     signal=impulse_signal(num_steps, amp, device))
    out = wgrun.execute(mesh, src, MultiNodeReceiver(rcv_idx), num_steps)
    traces = out["outputs"].cpu().numpy()        # (T, N)

    # true node distances (receivers snap to the grid)
    actual_d = np.array([np.linalg.norm(desc.position(loc) - source)
                         for loc in rcv_locs])
    peaks = []
    for i, d in enumerate(actual_d):
        if args.duct:
            window = traces[:, i]
        else:
            t_cut = int((d + 1.2) / c * fs)      # before first reflection
            window = traces[:t_cut, i]
        peaks.append(float(np.abs(window).max()))
    peaks = np.asarray(peaks)

    print("distance_m,peak,peak_times_r")
    for d, p in zip(actual_d, peaks):
        print(f"{d:.2f},{p:.6e},{p * d:.6e}")
    pr = peaks * actual_d
    report = {"inv_r_spread": float(pr.max() / pr.min()),
              "mode": "duct" if args.duct else "free_field",
              "stable": bool(out["stable"])}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
