"""Measured vs Sabine reverb time for three shoebox rooms (the reference's
``tools/rt60.py``, after wayverb's bin/rt60: waveguide-only decays at
absorption 0.1).

    python -m wayverb_tpu_torch.tools.rt60 [--time 2.0] [--cpu]
"""

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--absorption", type=float, default=0.1)
    ap.add_argument("--cutoff", type=float, default=500.0)
    ap.add_argument("--usable-portion", type=float, default=0.6)
    ap.add_argument("--time", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.signal.filters import decay_time
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_sampling_frequency, grid_spacing)

    device = device_for(args.cpu)
    env = Environment()
    fs = compute_sampling_frequency(args.cutoff, args.usable_portion)
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)

    rooms = {
        "small": (2.0, 2.5, 3.0),
        "medium": (4.5, 2.5, 3.5),
        "large": (12.0, 4.0, 8.0),
    }
    report = {}
    for name, dims in rooms.items():
        dims = np.asarray(dims)
        box = Box((0, 0, 0), tuple(dims))
        vol = float(np.prod(dims))
        area = float(2 * (dims[0] * dims[1] + dims[1] * dims[2]
                          + dims[0] * dims[2]))
        sabine = 0.161 * vol / (area * args.absorption)
        mesh = wgrun.shoebox_mesh(box, np.full((1, 8), args.absorption), dx,
                                  fs, device=device)
        out = wgrun.canonical(mesh, tuple(dims * 0.35), tuple(dims * 0.65),
                              args.time, env)
        t30 = float(decay_time(out.pressure, out.sample_rate, -5, -35))
        report[name] = {
            "sabine_s": sabine,
            "measured_t30_s": t30,
            "error_percent": (t30 - sabine) / sabine * 100.0,
            "stable": bool(out.stable),
        }
        print(f"{name}: sabine {sabine:.3f}s measured {t30:.3f}s "
              f"({report[name]['error_percent']:+.1f}%)")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
