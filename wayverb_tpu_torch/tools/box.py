"""Shoebox early-IR comparison (the reference's ``tools/box.py``, after
wayverb's bin/box): image sources found from a ray trace and validated,
against the exact lattice solver; then the early IR of the traced image
sources plus the direct path.

    python -m wayverb_tpu_torch.tools.box [--rays 32768] [--out ir.wav] [--cpu]

``main`` returns what it prints: {"traced_paths", "matched", "ir_samples",
"peak", "wrote"}; the IR itself goes to ``--out`` (float32 WAV).
"""

import argparse

import numpy as np
import torch


BOX = ((0, 0, 0), (5.56, 3.97, 2.81))
SOURCE, RECEIVER = (2.09, 2.12, 2.12), (2.09, 3.08, 0.96)


def image_sources(rays, max_order, absorption, device, directions=None):
    """(the image sources traced and validated, the exact lattice's) on
    ``device``: a ``trace_jit`` of ``max_order + 1`` bounces from a
    generator seeded with 0 (or ``directions``), then
    ``find_image_source_impulses``; and ``exact.find_impulses`` within
    25 m."""
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.imagesource import exact
    from wayverb_tpu_torch.imagesource.tree import find_image_source_impulses
    from wayverb_tpu_torch.raytracer import tracer

    box = Box(*BOX)
    soup = box_scene(box).to(device)
    surf = Surface(absorption=torch.full((1, 8), absorption, device=device),
                   scattering=torch.zeros((1, 8), device=device))
    res = tracer.trace_jit(soup, surf, SOURCE, RECEIVER,
                           torch.Generator(device).manual_seed(0),
                           num_rays=rays, depth=max_order + 1, max_time=0.5,
                           directions=directions)
    found = find_image_source_impulses(
        res.triangle_history, soup, surf, SOURCE, RECEIVER, max_order)
    oracle = exact.find_impulses(
        box, SOURCE, RECEIVER, torch.full((8,), absorption, device=device),
        25.0)
    return found, oracle


def main(argv=None, *, directions=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 15)
    ap.add_argument("--max-order", type=int, default=3)
    ap.add_argument("--absorption", type=float, default=0.1)
    ap.add_argument("--sample-rate", type=float, default=16000.0)
    ap.add_argument("--out", default=None, help="write IR wav here")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.attenuator import Null
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.impulse import apply_distance_pressure
    from wayverb_tpu_torch.imagesource import exact
    from wayverb_tpu_torch.imagesource.postprocess import postprocess
    from wayverb_tpu_torch.tools._cli import device_for

    device = device_for(args.cpu)
    found, oracle = image_sources(args.rays, args.max_order,
                                  args.absorption, device, directions)
    f_d = np.sort(found.distance.cpu().numpy())
    o_d = oracle.distance.cpu().numpy()[
        oracle.volume[:, 0].cpu().numpy() != 0]
    matched = sum(1 for d in f_d if np.min(np.abs(o_d - d)) < 1e-3)
    print(f"traced paths: {len(f_d)}  matched to exact lattice: {matched}")

    soup = box_scene(Box(*BOX)).to(device)
    both = found.concatenate(exact.get_direct(SOURCE, RECEIVER, soup))
    ir = postprocess(apply_distance_pressure(both, 400.0), Null(), RECEIVER,
                     340.0, args.sample_rate).cpu().numpy()
    peak = float(np.abs(ir).max())
    print(f"IR: {ir.shape[-1]} samples, peak {peak:.4f}")
    if args.out:
        from wayverb_tpu_torch.utils.audio import write_wav
        write_wav(args.out, ir, args.sample_rate)
        print("wrote", args.out)
    return {"traced_paths": len(f_d), "matched": matched,
            "ir_samples": int(ir.shape[-1]), "peak": peak, "wrote": args.out}


if __name__ == "__main__":
    main()
