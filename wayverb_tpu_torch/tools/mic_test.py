"""Microphone polar-pattern measurement (the reference's
``tools/mic_test.py``, after wayverb's bin/mic_test): sources on a circle
around a directional receiver; the waveguide's intensity-vector output is
rendered through ``Microphone`` capsules of shape 0 (omni), 0.5 (cardioid)
and 1.0 (bidirectional), and the measured energy per angle is compared with
the analytic pattern ((1−s) + s·cosθ)².  Prints CSV angle_deg, then
measured/expected per shape, then one JSON line.

    python -m wayverb_tpu_torch.tools.mic_test [--angles 12] [--cpu]
"""

import argparse
import json
import math

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--angles", type=int, default=12)
    ap.add_argument("--cutoff", type=float, default=500.0)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.attenuator import Microphone
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.core.orientation import Orientation
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_sampling_frequency, grid_spacing)
    from wayverb_tpu_torch.waveguide.postprocess import attenuate

    device = device_for(args.cpu)
    env = Environment()
    fs = compute_sampling_frequency(args.cutoff, 0.6)
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    room = 2 * args.radius + 2.0
    box = Box((0, 0, 0), (room, room, room))
    centre = np.array([room / 2, room / 2, room / 2])
    # near-anechoic walls so only the direct wave matters
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.99), dx, fs,
                              device=device)

    shapes = [0.0, 0.5, 1.0]
    mics = [Microphone(orientation=Orientation(pointing=(0.0, 0.0, 1.0)),
                       shape=s) for s in shapes]
    sim_time = 1.5 * args.radius / env.speed_of_sound + 0.005

    rows = []
    worst = 0.0
    for k in range(args.angles):
        theta = 2 * math.pi * k / args.angles
        src = centre + args.radius * np.array(
            [math.sin(theta), 0.0, math.cos(theta)])
        # the source snaps to a grid node: use the actual incident
        # direction for the expected pattern, and normalise each shape by
        # the measured omni energy at the same angle so propagation
        # effects (distance, direction-dependent dispersion) cancel
        src_node = mesh.descriptor.position(mesh.require_inside(tuple(src)))
        incident = np.asarray(src_node) - centre
        cos = incident[2] / np.linalg.norm(incident)
        out = wgrun.canonical(mesh, tuple(src), tuple(centre), sim_time, env)
        row = {"angle_deg": math.degrees(theta)}
        for s, mic in zip(shapes, mics):
            sig = attenuate(mic, env.acoustic_impedance, out.intensity,
                            out.pressure)
            row[f"shape_{s}"] = float(torch.sum(sig ** 2))
            row[f"expected_{s}"] = ((1.0 - s) + s * cos) ** 2
        rows.append(row)

    print("angle_deg," + ",".join(
        f"measured_{s},expected_{s}" for s in shapes))
    for row in rows:
        cells = [f"{row['angle_deg']:.1f}"]
        omni = row["shape_0.0"]
        for s in shapes:
            measured = row[f"shape_{s}"] / omni if omni else 0.0
            expected = row[f"expected_{s}"]
            cells += [f"{measured:.4f}", f"{expected:.4f}"]
            worst = max(worst, abs(measured - expected))
        print(",".join(cells))
    report = {"max_abs_pattern_error": worst}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
