"""Offline visualisation: wavefront slices and traced ray paths (the
reference's ``tools/visualize.py``).

The reference GUI renders the live waveguide pressure field and the ray
paths in its 3-D scene view; this tool renders the same data to PNGs.  The
reference draws with matplotlib; the port draws its own pictures with the
standard library (``zlib`` and ``struct``), so it needs no plotting package:

 * ``wavefront_{step:04d}.png``: the pressure in the source's z plane, x to
   the right and y up, through a symmetric diverging map (ColorBrewer's
   RdBu, negative red, positive blue) with limits ±max|p|, as the
   reference's ``imshow(cmap="RdBu", vmin=-limit, vmax=limit)``;
 * ``ray_paths.png``: the top view of the rays over the box's extent, each
   ray a polyline from the source through its reflection points, the source
   marked green and the receiver red.

The pictures carry no text: no title, colour bar or legend.  ``main``
returns what it drew: {"wavefronts": [{"step", "path", "slice" ((Y, X)
host array, row 0 at y = 0)}], "rays": {"path", "polylines" ((R, depth + 1,
3) host array)}}.

    python -m wayverb_tpu_torch.tools.visualize [--out-dir viz]
        [--frames 8] [--rays 24] [--cpu]
"""

import argparse
import os
import struct
import zlib

import numpy as np
import torch

# ColorBrewer's 11-class RdBu, from the low end to the high end
RDBU = np.array([
    (103, 0, 31), (178, 24, 43), (214, 96, 77), (244, 165, 130),
    (253, 219, 199), (247, 247, 247), (209, 229, 240), (146, 197, 222),
    (67, 147, 195), (33, 102, 172), (5, 48, 97)], dtype=np.float64)
# matplotlib's default line colours (tab10), one a ray in turn
LINE_COLOURS = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207)], dtype=np.float64)
SOURCE_COLOUR = (0.0, 128.0, 0.0)
RECEIVER_COLOUR = (255.0, 0.0, 0.0)


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of the (H, W, 3) uint8 array, row 0 at the top."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    height, width, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[row].tobytes() for row in range(height))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def diverging(values: np.ndarray, limit: float) -> np.ndarray:
    """(..., 3) uint8 colours of ``values`` on RdBu over [-limit, limit]."""
    u = np.clip((np.asarray(values, np.float64) / limit + 1.0) / 2.0, 0, 1)
    pos = u * (len(RDBU) - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), len(RDBU) - 2)
    frac = (pos - lo)[..., None]
    return np.round(RDBU[lo] * (1 - frac) + RDBU[lo + 1] * frac).astype(
        np.uint8)


def slice_image(plane: np.ndarray, min_pixels: int = 400) -> np.ndarray:
    """The (Y, X) slice as an RGB image, y up, each node a square of
    pixels so the longer side has at least ``min_pixels``."""
    limit = max(float(np.abs(plane).max()), 1e-6)
    scale = max(1, -(-min_pixels // max(plane.shape)))
    rgb = diverging(plane[::-1], limit)
    return np.repeat(np.repeat(rgb, scale, axis=0), scale, axis=1)


def _blend(canvas, rows, cols, colour, alpha):
    inside = ((rows >= 0) & (rows < canvas.shape[0]) & (cols >= 0)
              & (cols < canvas.shape[1]))
    rows, cols = rows[inside], cols[inside]
    canvas[rows, cols] = (1 - alpha) * canvas[rows, cols] + alpha * np.asarray(
        colour)


def ray_image(polylines: np.ndarray, source, receiver, extent,
              size=(660, 495)) -> np.ndarray:
    """Top view (x right, y up) of the (R, P, ≥2) polylines over
    ``extent`` = (x_max, y_max) from the origin, on a white canvas of
    ``size`` = (width, height) pixels."""
    width, height = size
    canvas = np.full((height, width, 3), 255.0)

    def to_pixel(x, y):
        return ((1.0 - np.asarray(y) / extent[1]) * (height - 1),
                np.asarray(x) / extent[0] * (width - 1))

    for r, line in enumerate(polylines):
        rows, cols = [], []
        for a, b in zip(line[:-1], line[1:]):
            (r0, c0), (r1, c1) = to_pixel(a[0], a[1]), to_pixel(b[0], b[1])
            n = int(max(abs(r1 - r0), abs(c1 - c0), 1.0)) + 1
            t = np.linspace(0.0, 1.0, n)
            rows.append(np.round(r0 + (r1 - r0) * t))
            cols.append(np.round(c0 + (c1 - c0) * t))
        pixels = np.unique(np.stack([np.concatenate(rows),
                                     np.concatenate(cols)], axis=1), axis=0)
        _blend(canvas, pixels[:, 0].astype(np.int64),
               pixels[:, 1].astype(np.int64),
               LINE_COLOURS[r % len(LINE_COLOURS)], 0.4)
    dr, dc = np.mgrid[-5:6, -5:6]
    disc = dr ** 2 + dc ** 2 <= 25
    for point, colour in ((source, SOURCE_COLOUR),
                          (receiver, RECEIVER_COLOUR)):
        row, col = to_pixel(point[0], point[1])
        _blend(canvas, int(round(float(row))) + dr[disc],
               int(round(float(col))) + dc[disc], colour, 1.0)
    return np.round(canvas).astype(np.uint8)


def main(argv=None, *, directions=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="viz")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--rays", type=int, default=24)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.geometry import Box, box_scene
    from wayverb_tpu_torch.core.surfaces import Surface
    from wayverb_tpu_torch.raytracer import tracer
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.utils.events import iter_pressure_fields
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
    from wayverb_tpu_torch.waveguide.sources import HardSource, impulse_signal

    device = device_for(args.cpu)
    os.makedirs(args.out_dir, exist_ok=True)
    box = Box((0, 0, 0), (4.0, 3.0, 3.2))
    src, rcv = (1.2, 1.5, 1.6), (2.8, 1.5, 1.6)

    # wavefront frames: slice through the source plane
    fs = 3333.33
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), dx, fs,
                              device=device)
    desc = mesh.descriptor
    sloc = mesh.require_inside(src)
    rloc = mesh.require_inside(rcv)
    steps = args.frames * 6
    source = HardSource(node_idx=desc.flat_index(sloc),
                        signal=impulse_signal(steps, 1.0, device))
    receiver = NodeReceiver(node_idx=torch.tensor(desc.flat_index(rloc),
                                                  device=device))
    z_slice = int(sloc[2])
    wavefronts = []
    for step, field, _ in iter_pressure_fields(mesh, source, receiver,
                                               steps, every=6):
        plane = field[:, :, z_slice].T.cpu().numpy()
        path = os.path.join(args.out_dir, f"wavefront_{step:04d}.png")
        write_png(path, slice_image(plane))
        print("wrote", path)
        wavefronts.append({"step": step, "path": path, "slice": plane})

    # ray paths
    soup = box_scene(box).to(device)
    surf = Surface(absorption=torch.full((1, 8), 0.1, device=device),
                   scattering=torch.full((1, 8), 0.1, device=device))
    res = tracer.trace(soup, surf, src, rcv,
                       torch.Generator(device).manual_seed(0),
                       num_rays=args.rays, depth=6, max_time=0.5,
                       capture_positions=True, directions=directions)
    pos = res.positions.cpu().numpy()                    # (depth, R, 3)
    start = np.broadcast_to(np.asarray(src, np.float32), (1,) + pos.shape[1:])
    polylines = np.transpose(np.concatenate([start, pos]), (1, 0, 2))
    path = os.path.join(args.out_dir, "ray_paths.png")
    write_png(path, ray_image(polylines, src, rcv,
                              (box.max_corner[0], box.max_corner[1])))
    print("wrote", path)
    return {"wavefronts": wavefronts,
            "rays": {"path": path, "polylines": polylines}}


if __name__ == "__main__":
    main()
