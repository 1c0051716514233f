"""Decay smoothness of the stochastic tail (the reference's
``tools/diffuse_decay.py``, after wayverb's bin/diffuse_decay): trace a
diffuse room, Schroeder-integrate the energy histogram per band and fit a
line; the residual from linearity measures how smooth, free of crackle, the
decay is.  Prints one JSON line of the setup, then one per band; ``main``
returns {"setup": the first line, "bands": the others}.

    python -m wayverb_tpu_torch.tools.diffuse_decay [--rays 65536] [--cpu]
"""

import argparse
import json

import numpy as np
import torch


def main(argv=None, *, directions=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 16)
    ap.add_argument("--absorption", type=float, default=0.1)
    ap.add_argument("--scattering", type=float, default=0.1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer import tracer
    from wayverb_tpu_torch.signal.filters import linear_regression
    from wayverb_tpu_torch.tools._cli import device_for

    device = device_for(args.cpu)
    env = Environment()
    dims = np.array([5.56, 3.97, 2.81])
    box = Box((0, 0, 0), tuple(dims))
    soup = box_scene(box).to(device)
    surfaces = Surface(
        absorption=torch.full((1, 8), args.absorption, device=device),
        scattering=torch.full((1, 8), args.scattering, device=device))

    volume = float(np.prod(dims))
    area = float(2 * (dims[0] * dims[1] + dims[1] * dims[2]
                      + dims[0] * dims[2]))
    sabine = 0.161 * volume / (area * args.absorption)
    depth = tracer.compute_optimum_reflection_number(args.absorption)

    res = tracer.trace_jit(
        soup, surfaces, (2.0, 1.5, 1.0), (3.5, 2.5, 1.8),
        torch.Generator(device).manual_seed(0), num_rays=args.rays,
        depth=depth, max_time=1.5 * sabine, environment=env,
        directions=directions)
    hist = res.summed_histogram().cpu().numpy()          # (bins, bands)
    sr = res.histogram_sample_rate

    setup = {"sabine_t60_s": sabine, "depth": depth, "rays": args.rays}
    print(json.dumps(setup))
    bands = []
    for b in range(hist.shape[1]):
        energy = hist[:, b]
        # Schroeder backward integral of energy, in dB
        sch = np.cumsum(energy[::-1])[::-1]
        sch = sch / max(sch[0], 1e-30)
        db = 10.0 * np.log10(np.maximum(sch, 1e-30))
        # fit over the -5..-35 dB stretch
        sel = (db <= -5.0) & (db >= -35.0)
        t = np.arange(db.size)[sel] / sr
        slope, intercept = linear_regression(
            torch.as_tensor(t, dtype=torch.float32),
            torch.as_tensor(db[sel], dtype=torch.float32))
        slope, intercept = float(slope), float(intercept)
        fitted = slope * t + intercept
        rms_dev_db = float(np.sqrt(np.mean((db[sel] - fitted) ** 2)))
        t30 = -60.0 / slope if slope < 0 else float("inf")
        line = {"band": b, "t30_s": t30,
                "t30_vs_sabine_percent": (t30 - sabine) / sabine * 100.0,
                "decay_rms_deviation_db": rms_dev_db}
        bands.append(line)
        print(json.dumps(line))
    return {"setup": setup, "bands": bands}


if __name__ == "__main__":
    main()
