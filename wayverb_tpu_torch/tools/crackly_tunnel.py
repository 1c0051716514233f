"""Crackle artefact hunt (the reference's ``tools/crackly_tunnel.py``, after
wayverb's bin/crackly_tunnel): the whole hybrid render in a long tunnel, the
geometry that historically provoked crackle in the stochastic tail, written
to WAV for listening, plus a crackle statistic (the largest sample-to-sample
jump relative to the local envelope).  Prints one JSON line; ``main``
returns it.

    python -m wayverb_tpu_torch.tools.crackly_tunnel [--length 30] [--cpu]
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch


def main(argv=None, *, directions=None, draws=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=float, default=30.0)
    ap.add_argument("--rays", type=int, default=1 << 14)
    ap.add_argument("--cutoff", type=float, default=400.0)
    ap.add_argument("--output-rate", type=float, default=16000.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "crackly_tunnel.wav"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.combined import engine as ce
    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.utils.audio import write_wav

    device = device_for(args.cpu)
    box = Box((0, 0, 0), (2.5, 2.5, args.length))
    soup = box_scene(box)
    surfaces = Surface(absorption=torch.full((1, 8), 0.1),
                       scattering=torch.full((1, 8), 0.1))

    eng = ce.Engine(soup, surfaces,
                    ce.WaveguideParameters(cutoff=args.cutoff),
                    scene_box=box, device=device)
    results = eng.run((1.2, 1.2, 2.0), (1.2, 1.2, args.length - 4.0),
                      torch.Generator(device).manual_seed(7),
                      ce.RaytracerParameters(rays=args.rays),
                      directions=directions)
    ir = ce.render(results, Null(), args.output_rate,
                   torch.Generator(device).manual_seed(8),
                   draws).cpu().numpy()
    ir = ir / max(np.abs(ir).max(), 1e-12)
    write_wav(args.out, ir, args.output_rate)

    # crackle statistic: largest first-difference vs the local RMS envelope
    diff = np.abs(np.diff(ir))
    win = max(int(args.output_rate * 0.01), 1)
    kernel = np.ones(win) / win
    envelope = np.sqrt(np.convolve(ir ** 2, kernel, mode="same") + 1e-20)
    crackle = diff / np.maximum(envelope[1:], 1e-10)
    report = {
        "wrote": args.out,
        "ir_seconds": ir.size / args.output_rate,
        "max_jump_over_envelope": float(crackle.max()),
        "p999_jump_over_envelope": float(np.quantile(crackle, 0.999))}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
