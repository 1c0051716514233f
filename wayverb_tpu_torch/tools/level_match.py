"""Hybrid level calibration check (the reference's ``tools/level_match.py``,
after wayverb's bin/siltanen2013 and bin/level_match): the calibrated
waveguide's direct-wave level must match the geometric solver's 1/r
pressure at the same distance.  Prints one line; ``main`` returns its
numbers.

    python -m wayverb_tpu_torch.tools.level_match [--distance 2.0] [--cpu]
"""

import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--distance", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing

    device = device_for(args.cpu)
    env = Environment()
    fs = 3333.33
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    d = args.distance

    # big box so the direct wave is clean before any reflection returns
    box = Box((0, 0, 0), (d + 6.0, 6.0, 6.2))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.5), dx, fs,
                              device=device)
    src = (3.0, 3.0, 3.1)
    rcv = (3.0 + d, 3.0, 3.1)
    sim_time = (d + 2.0) / env.speed_of_sound
    out = wgrun.canonical(mesh, src, rcv, sim_time, env)
    p = out.pressure.cpu().numpy()

    # compare amplitude SPECTRA in the valid band: the mesh disperses the
    # dirac, so the raw peak is meaningless, but in-band spectral level is
    # what the siltanen2013 calibration matches
    spec = np.abs(np.fft.rfft(p)) / 1.0  # unit-impulse input: |H| directly
    freqs = np.fft.rfftfreq(p.size, 1.0 / fs)
    expected = np.sqrt(env.acoustic_impedance / (4 * np.pi)) / d
    band = (freqs > 50.0) & (freqs < 0.2 * fs)
    measured = spec[band]
    ratio = measured / expected
    print(f"distance {d} m: in-band |P|/geometric ratio: "
          f"mean {ratio.mean():.3f}, spread "
          f"[{ratio.min():.3f}, {ratio.max():.3f}]")
    return {"distance_m": d, "mean_ratio": float(ratio.mean()),
            "min_ratio": float(ratio.min()), "max_ratio": float(ratio.max())}


if __name__ == "__main__":
    main()
