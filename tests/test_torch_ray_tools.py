"""The port's ray tools (``wayverb_tpu_torch/tools``: ``box``,
``diffuse_decay``, ``crackly_tunnel``, ``visualize``) against the
reference's scripts (``tools/``), on the CPU: each reference script's
``main`` with ``sys.argv`` set beside the port's ``main(argv)`` with the
same small flags, the reference's ``jax.random`` draws fed to the port
(``directions=``, ``draws=``).

Tolerances: printed numbers within one unit of their last printed digit or
1e-5 of their value, counts and flags equal; ``box``'s IR within 1e-5 of
its peak (a dense scene of 12 triangles: the same paths, the same sinc
deposit); ``diffuse_decay``'s per-band T30 rtol 1e-3; ``crackly_tunnel``'s
IR within 1e-3 of peak (``IR_REL`` of ``test_torch_engine.py``: XLA's fused
multiply-adds on the waveguide's long recurrence) and its two crackle
statistics rtol ``CRACKLE_REL`` (below); ``visualize``'s slices within 2e-5
of their peak and its polylines within 1e-5 m.
"""

import json
import math
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import IR_REL
from test_torch_raytracer import reference_dirac_draws, reference_directions
from test_torch_tools import _port, _reference
from wayverb_tpu_torch.utils.audio import read_wav

torch.set_num_threads(2)

# The crackle statistics divide a sample-to-sample jump by a 10 ms RMS
# envelope.  IR_REL bounds the IR's difference but not such a ratio: the
# largest jump sits where the envelope is 2.5e-3 of peak (sample 9,870 of
# the reference's IR), below the bound itself.  On these draws the IRs part
# by 1.0e-4 of peak and the statistics by 1.5e-6 (max) and 5.2e-3 (99.9 %
# quantile) of their value; an IR difference at the bound, ten times the one
# measured, moves them ten times as far: 5.2e-2 for the quantile.  So they
# are held at 5e-2.
CRACKLE_REL = 5e-2


def _digits_close(want: str, got: str):
    """Printed numbers: within one unit of the last digit or 1e-5 of the
    value."""
    digits = len(want.split(".")[1].split("e")[0]) if "." in want else 0
    unit = 10.0 ** -digits
    if "e" in want:
        unit *= 10.0 ** int(want.split("e")[1])
    assert abs(float(want) - float(got)) <= max(
        unit * 1.01, 1e-5 * abs(float(want))), (want, got)


def test_box(monkeypatch, capsys, tmp_path):
    """Equal traced and matched counts, the IR within 1e-5 of peak."""
    argv = ["--rays", "1024", "--cpu"]
    ref_wav, port_wav = str(tmp_path / "ref.wav"), str(tmp_path / "port.wav")
    want = _reference("box", argv + ["--out", ref_wav], monkeypatch, capsys)
    lines, report = _port("box", argv + ["--out", port_wav], capsys,
                          directions=reference_directions(
                              jax.random.PRNGKey(0), 1024, 4))
    assert lines[0] == want[0]
    assert lines[0] == (f"traced paths: {report['traced_paths']}  matched "
                        f"to exact lattice: {report['matched']}")
    assert report["traced_paths"] == report["matched"] > 0
    w_n, w_peak = want[1].split(": ")[1].split(" samples, peak ")
    assert report["ir_samples"] == int(w_n)
    _digits_close(w_peak, f"{report['peak']:.4f}")
    assert lines[2] == want[2].replace(ref_wav, port_wav)
    got, got_sr = read_wav(port_wav)
    ref, ref_sr = read_wav(ref_wav)
    assert got_sr == ref_sr and got.shape == ref.shape
    peak = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * peak)
    assert np.abs(got).max() == pytest.approx(report["peak"], rel=1e-6)


def test_diffuse_decay(monkeypatch, capsys):
    """The setup line equal; each band's T30 rtol 1e-3."""
    from wayverb_tpu_torch.raytracer.tracer import \
        compute_optimum_reflection_number
    argv = ["--rays", "1024", "--cpu"]
    want = [json.loads(ln) for ln in
            _reference("diffuse_decay", argv, monkeypatch, capsys)]
    depth = compute_optimum_reflection_number(0.1)
    lines, report = _port("diffuse_decay", argv, capsys,
                          directions=reference_directions(
                              jax.random.PRNGKey(0), 1024, depth))
    got = [json.loads(ln) for ln in lines]
    assert got == [report["setup"], *report["bands"]]
    assert got[0] == want[0] and len(got) == len(want) == 9
    for g, w in zip(got[1:], want[1:]):
        assert g["band"] == w["band"]
        assert g["t30_s"] == pytest.approx(w["t30_s"], rel=1e-3)
        assert g["t30_vs_sabine_percent"] == pytest.approx(
            w["t30_vs_sabine_percent"], abs=1e-3 * abs(w["t30_s"])
            / want[0]["sabine_t60_s"] * 100.0 + 1e-9)


def test_crackly_tunnel(monkeypatch, capsys, tmp_path):
    """The IR within ``IR_REL`` of peak; the crackle statistics rtol
    ``CRACKLE_REL``."""
    from wayverb_tpu_torch.combined.engine import (RaytracerParameters,
                                                   optimum_depth)
    from wayverb_tpu_torch.core.surfaces import Surface
    argv = ["--length", "8", "--rays", "1024", "--cutoff", "200", "--cpu"]
    ref_wav, port_wav = str(tmp_path / "ref.wav"), str(tmp_path / "port.wav")
    want = json.loads(_reference("crackly_tunnel", argv + ["--out", ref_wav],
                                 monkeypatch, capsys)[-1])
    depth = optimum_depth(Surface(absorption=torch.full((1, 8), 0.1),
                                  scattering=torch.full((1, 8), 0.1)))
    params = RaytracerParameters()
    bins = int(math.ceil(params.max_time * params.histogram_sample_rate)) + 1
    n = int(math.ceil(bins / params.histogram_sample_rate * 16000.0))
    lines, report = _port(
        "crackly_tunnel", argv + ["--out", port_wav], capsys,
        directions=reference_directions(jax.random.PRNGKey(7), 1024, depth),
        draws=reference_dirac_draws(jax.random.PRNGKey(8), n))
    assert json.loads(lines[-1]) == report
    assert report["wrote"] == port_wav
    assert report["ir_seconds"] == want["ir_seconds"]
    got, got_sr = read_wav(port_wav)
    ref, ref_sr = read_wav(ref_wav)
    assert got_sr == ref_sr and got.shape == ref.shape
    assert np.abs(ref).max() == np.abs(got).max() == 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=IR_REL)
    for key in ("max_jump_over_envelope", "p999_jump_over_envelope"):
        assert report[key] == pytest.approx(want[key], rel=CRACKLE_REL), key


def read_png(path):
    """(height, width, rows) of an 8-bit RGB PNG, every chunk's CRC
    checked, every row's filter byte 0 (as the port writes them)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    assert kind == b"IEND" and pos == len(data)
    width, height, depth, colour = header[:4]
    assert (depth, colour) == (8, 2)
    raw = zlib.decompress(idat)
    assert len(raw) == height * (1 + 3 * width)
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + 3 * width)
    assert np.all(rows[:, 0] == 0)
    return height, width, rows[:, 1:].reshape(height, width, 3)


def test_visualize(monkeypatch, capsys, tmp_path):
    """The slices the reference hands to ``imshow`` and the polylines it
    hands to ``plot``, against what the port drew; every PNG decoded."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from wayverb_tpu_torch.tools import visualize

    drawn = {"slices": [], "lines": []}
    imshow, plot = plt.imshow, plt.plot

    def record_imshow(plane, *args, **kwargs):
        drawn["slices"].append(np.array(plane))
        assert kwargs["vmin"] == -kwargs["vmax"] and kwargs["cmap"] == "RdBu"
        return imshow(plane, *args, **kwargs)

    def record_plot(xs, ys, *args, **kwargs):
        drawn["lines"].append(np.stack([xs, ys], axis=1))
        return plot(xs, ys, *args, **kwargs)

    monkeypatch.setattr(plt, "imshow", record_imshow)
    monkeypatch.setattr(plt, "plot", record_plot)
    argv = ["--frames", "2", "--rays", "8", "--cpu"]
    want = _reference("visualize",
                      argv + ["--out-dir", str(tmp_path / "ref")],
                      monkeypatch, capsys)
    out_dir = str(tmp_path / "port")
    lines, report = _port("visualize", argv + ["--out-dir", out_dir], capsys,
                          directions=reference_directions(
                              jax.random.PRNGKey(0), 8, 6))
    assert [os.path.basename(ln) for ln in lines] == [
        os.path.basename(ln) for ln in want]

    assert len(report["wavefronts"]) == len(drawn["slices"]) == 2
    for frame, ref in zip(report["wavefronts"], drawn["slices"]):
        assert frame["slice"].shape == ref.shape
        np.testing.assert_allclose(frame["slice"], ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
        height, width, rgb = read_png(frame["path"])
        scale = -(-400 // max(ref.shape))
        assert (height, width) == (ref.shape[0] * scale,
                                   ref.shape[1] * scale)
        np.testing.assert_array_equal(
            rgb, visualize.slice_image(frame["slice"]))

    polylines = report["rays"]["polylines"]
    assert polylines.shape == (8, 7, 3) and len(drawn["lines"]) == 8
    np.testing.assert_allclose(polylines[:, :, :2], np.stack(drawn["lines"]),
                               rtol=0, atol=1e-5)
    height, width, rgb = read_png(report["rays"]["path"])
    assert (height, width) == (495, 660)
    # the source's green marker and the receiver's red one are drawn
    assert np.any(np.all(rgb == (0, 128, 0), axis=-1))
    assert np.any(np.all(rgb == (255, 0, 0), axis=-1))


def test_diverging_map_is_symmetric():
    """RdBu with limits ±limit: 0 is the middle colour, ±limit and beyond
    the ends."""
    from wayverb_tpu_torch.tools.visualize import RDBU, diverging
    values = np.linspace(-2.0, 2.0, 41)
    rgb = diverging(values, 2.0)
    np.testing.assert_array_equal(rgb[20], RDBU[5])
    np.testing.assert_array_equal(rgb[0], RDBU[0])
    np.testing.assert_array_equal(rgb[-1], RDBU[-1])
    np.testing.assert_array_equal(diverging([5.0, -5.0], 2.0),
                                  [RDBU[-1], RDBU[0]])

