"""PCS source experiment (the reference's ``tools/sheaffer2014.py``, after
wayverb's bin/sheaffer2014, replicating sheaffer2014 §V-A): inject a
physically-constrained source — maxflat FIR pulse shaped by the
pulsating-sphere mechanical filter and the injection filter — as a soft
source in a large room, record the pressure at 1 m, and write the pulse and
the response to WAV.  The PCS pulse must be DC-free and the response must
stay bounded (no solution growth from the source).  Prints one JSON line.

    python -m wayverb_tpu_torch.tools.sheaffer2014 [--out-prefix P] [--cpu]
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cutoff", type=float, default=500.0)
    ap.add_argument("--time", type=float, default=0.2)
    ap.add_argument("--mass", type=float, default=0.025)
    ap.add_argument("--low-cutoff-hz", type=float, default=100.0)
    ap.add_argument("--low-q", type=float, default=0.7)
    ap.add_argument("--out-prefix",
                    default=os.path.join(tempfile.gettempdir(),
                                         "sheaffer2014"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.utils.audio import write_wav
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_sampling_frequency, grid_spacing)
    from wayverb_tpu_torch.waveguide.excitation import design_pcs_source
    from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
    from wayverb_tpu_torch.waveguide.sources import SoftSource

    device = device_for(args.cpu)
    env = Environment()
    fs = compute_sampling_frequency(args.cutoff, 0.6)
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    box = Box((0, 0, 0), (6.0, 6.0, 6.0))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.3), dx, fs,
                              device=device)
    desc = mesh.descriptor

    num_steps = int(args.time * fs)
    pulse, offset = design_pcs_source(
        num_steps, env.acoustic_impedance, env.speed_of_sound, fs,
        radius=desc.spacing * 0.5, sphere_mass=args.mass,
        low_cutoff_hz=args.low_cutoff_hz, low_q=args.low_q)

    src = SoftSource(
        node_idx=int(desc.flat_index(mesh.require_inside((3.0, 3.0, 3.0)))),
        signal=torch.as_tensor(pulse, dtype=torch.float32, device=device))
    rcv = NodeReceiver(node_idx=torch.tensor(
        desc.flat_index(mesh.require_inside((3.0, 3.0, 4.0))),
        device=device))
    out = wgrun.execute(mesh, src, rcv, num_steps)
    response = out["outputs"].cpu().numpy()

    write_wav(f"{args.out_prefix}.pulse.wav",
              pulse / max(np.abs(pulse).max(), 1e-12), fs)
    write_wav(f"{args.out_prefix}.response.wav",
              response / max(np.abs(response).max(), 1e-12), fs)

    spec = np.abs(np.fft.rfft(pulse))
    report = {
        "sample_rate_hz": fs,
        "pulse_offset_samples": offset,
        "pulse_dc_over_peak": float(spec[0] / spec.max()),
        "response_peak": float(np.abs(response).max()),
        "response_tail_over_peak": float(
            np.abs(response[-num_steps // 10:]).max()
            / np.abs(response).max()),
        "stable": bool(out["stable"]),
        "wrote": [f"{args.out_prefix}.pulse.wav",
                  f"{args.out_prefix}.response.wav"]}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
