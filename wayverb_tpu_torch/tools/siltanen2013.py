"""Hybrid level-calibration experiment (the reference's
``tools/siltanen2013.py``, after wayverb's bin/siltanen2013 and
bin/level_match): in a shoebox, the calibrated waveguide's direct-field
spectral level must land on the geometric (image-source) level √(Z/4π)/d,
so the two solvers splice at the crossover without a level step.  Prints
the in-band level ratio per frequency bin and a JSON summary.

    python -m wayverb_tpu_torch.tools.siltanen2013 [--time 0.08] [--cpu]
"""

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--distance", type=float, default=2.0)
    ap.add_argument("--sample-rate", type=float, default=3333.33)
    ap.add_argument("--time", type=float, default=0.08)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

    device = device_for(args.cpu)
    env = Environment()
    fs = args.sample_rate
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    d = args.distance

    # large, highly absorptive box: the windowed output is direct-only
    box = Box((0, 0, 0), (12.0, 10.0, 10.2))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.95), dx, fs,
                              device=device)
    out = wgrun.canonical(mesh, (5.0, 5.0, 5.1), (5.0 + d, 5.0, 5.1),
                          args.time, env)
    p = out.pressure.cpu().numpy()

    spec = np.abs(np.fft.rfft(p))
    freqs = np.fft.rfftfreq(p.size, 1.0 / fs)
    geometric = np.sqrt(env.acoustic_impedance / (4 * np.pi)) / d
    band = (freqs > 50.0) & (freqs < 0.2 * fs)

    print("freq_hz,waveguide_over_geometric")
    for f, s in zip(freqs[band], spec[band]):
        print(f"{f:.1f},{s / geometric:.4f}")
    ratio = spec[band] / geometric
    report = {
        "mean_level_ratio": float(ratio.mean()),
        "mean_level_error_db": float(20 * np.log10(ratio.mean())),
        "stable": bool(out.stable)}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
