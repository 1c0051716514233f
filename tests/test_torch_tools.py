"""The port's waveguide validation tools (``wayverb_tpu_torch/tools``)
against the reference's scripts (``tools/``), on the CPU: each reference
script's ``main`` with ``sys.argv`` set and its output captured, beside the
port's ``main(argv)`` with the same flags, at small sizes (the reference's
defaults where it has no size flag: ``level_match`` is 39 steps on a
45 × 34 × 35 grid, ``boundary_test`` two runs of 110 steps).

Tolerances, per tool: printed CSV cells within one unit of their last
printed digit or 1e-5 of their value (both packages round the same
numbers, which differ in the sixth or seventh digit: XLA contracts a·b + c
into FMAs, eager torch does not); derived reports (T30, level ratios,
peaks) rtol 1e-3; flags equal.
"""

import csv
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-3


def _reference(name, argv, monkeypatch, capsys):
    """The reference script's printed lines for ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


def _port(name, argv, capsys):
    """(the port's printed lines, ``main``'s report) for ``argv``."""
    module = importlib.import_module(f"wayverb_tpu_torch.tools.{name}")
    capsys.readouterr()
    report = module.main(argv)
    return capsys.readouterr().out.splitlines(), report


def _csv_close(want_lines, got_lines):
    """CSV blocks: the same header and row count, every cell within one
    unit of its last printed digit or 1e-5 of its value."""
    want = list(csv.reader(io.StringIO("\n".join(want_lines))))
    got = list(csv.reader(io.StringIO("\n".join(got_lines))))
    assert want[0] == got[0] and len(want) == len(got)
    for w_row, g_row in zip(want[1:], got[1:]):
        assert len(w_row) == len(g_row)
        for w, g in zip(w_row, g_row):
            digits = len(w.split(".")[1].split("e")[0]) if "." in w else 0
            unit = 10.0 ** -digits
            if "e" in w:
                unit *= 10.0 ** int(w.split("e")[1])
            assert abs(float(w) - float(g)) <= max(
                unit * 1.01, 1e-5 * abs(float(w))), (w_row, g_row)


def _close(got, want, rel=REL):
    assert got == pytest.approx(want, rel=rel), (got, want)


def test_rt60(monkeypatch, capsys):
    argv = ["--time", "0.1", "--cpu"]
    want = json.loads(_reference("rt60", argv, monkeypatch, capsys)[-1])
    lines, report = _port("rt60", argv, capsys)
    assert json.loads(lines[-1]) == report
    assert set(report) == set(want) == {"small", "medium", "large"}
    for room in want:
        assert report[room]["sabine_s"] == want[room]["sabine_s"]
        assert report[room]["stable"] is want[room]["stable"] is True
        _close(report[room]["measured_t30_s"], want[room]["measured_t30_s"])


def test_mic_test(monkeypatch, capsys):
    argv = ["--angles", "4", "--cpu"]
    want = _reference("mic_test", argv, monkeypatch, capsys)
    lines, report = _port("mic_test", argv, capsys)
    assert json.loads(lines[-1]) == report
    _csv_close(want[:-1], lines[:-1])
    assert report["max_abs_pattern_error"] == pytest.approx(
        json.loads(want[-1])["max_abs_pattern_error"], abs=1e-4)


def test_siltanen2013(monkeypatch, capsys):
    argv = ["--time", "0.03", "--cpu"]
    want = _reference("siltanen2013", argv, monkeypatch, capsys)
    lines, report = _port("siltanen2013", argv, capsys)
    assert json.loads(lines[-1]) == report
    _csv_close(want[:-1], lines[:-1])
    w = json.loads(want[-1])
    _close(report["mean_level_ratio"], w["mean_level_ratio"])
    assert report["stable"] is w["stable"] is True


def test_level_match(monkeypatch, capsys):
    """The reference's defaults: 39 steps on a 45 × 34 × 35 grid."""
    want = _reference("level_match", ["--cpu"], monkeypatch, capsys)
    lines, report = _port("level_match", ["--cpu"], capsys)
    assert lines == want
    _close(report["mean_ratio"], float(want[0].split("mean ")[1][:5]),
           rel=2e-3)


def test_waveguide_distance_test(monkeypatch, capsys):
    argv = ["--max-distance", "2.0", "--cpu"]
    want = _reference("waveguide_distance_test", argv, monkeypatch, capsys)
    lines, report = _port("waveguide_distance_test", argv, capsys)
    assert json.loads(lines[-1]) == report
    _csv_close(want[:-1], lines[:-1])
    w = json.loads(want[-1])
    _close(report["inv_r_spread"], w["inv_r_spread"])
    assert (report["mode"], report["stable"]) == (w["mode"], w["stable"])


def test_solution_growth(monkeypatch, capsys):
    argv = ["--time", "0.05", "--cpu"]
    want = [json.loads(ln) for ln in
            _reference("solution_growth", argv, monkeypatch, capsys)]
    lines, report = _port("solution_growth", argv, capsys)
    got = [json.loads(ln) for ln in lines]
    assert got[:-1] == report["runs"] and got[-1] == {
        "all_decaying": report["all_decaying"]}
    assert len(got) == len(want) == 5
    for g, w in zip(got[:-1], want[:-1]):
        for key in ("signal", "source", "stable", "grew"):
            assert g[key] == w[key]
        for key in ("peak", "tail_peak", "tail_over_peak"):
            _close(g[key], w[key])
    assert report["all_decaying"] is want[-1]["all_decaying"] is True


def test_sheaffer2014(monkeypatch, capsys, tmp_path):
    """The report, and the two WAV files each script writes under
    ``tmp_path``."""
    from wayverb_tpu_torch.utils.audio import read_wav
    ref_prefix, port_prefix = str(tmp_path / "ref"), str(tmp_path / "port")
    argv = ["--time", "0.05", "--cpu"]
    w = json.loads(_reference("sheaffer2014", argv + ["--out-prefix",
                                                      ref_prefix],
                              monkeypatch, capsys)[-1])
    lines, report = _port("sheaffer2014",
                          argv + ["--out-prefix", port_prefix], capsys)
    assert json.loads(lines[-1]) == report
    for key in ("sample_rate_hz", "pulse_offset_samples", "stable"):
        assert report[key] == w[key]
    for key in ("pulse_dc_over_peak", "response_peak",
                "response_tail_over_peak"):
        _close(report[key], w[key])
    for kind in ("pulse", "response"):
        want_wav, want_sr = read_wav(f"{ref_prefix}.{kind}.wav")
        got_wav, got_sr = read_wav(f"{port_prefix}.{kind}.wav")
        assert got_sr == want_sr and got_wav.shape == want_wav.shape
        np.testing.assert_allclose(got_wav, want_wav, rtol=0, atol=1e-4)
    assert report["wrote"] == [f"{port_prefix}.pulse.wav",
                               f"{port_prefix}.response.wav"]


def test_boundary_test(monkeypatch, capsys):
    """The reference's only geometry: two runs of 110 steps."""
    want = _reference("boundary_test", ["--cpu"], monkeypatch, capsys)
    lines, report = _port("boundary_test", ["--cpu"], capsys)
    _csv_close(want, lines)
    rows = list(csv.reader(io.StringIO("\n".join(want))))[1:]
    assert report["valid"] == [r[3] == "1" for r in rows]
    np.testing.assert_allclose(report["measured"],
                               [float(r[1]) for r in rows], atol=1e-4)


TOOLS = ("rt60", "mic_test", "siltanen2013", "level_match",
         "waveguide_distance_test", "solution_growth", "sheaffer2014",
         "boundary_test")


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_on_the_card_unless_cpu(name):
    """Without ``--cpu`` a tool runs on the card, and raises where there is
    none (before any work)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run on it")
    module = importlib.import_module(f"wayverb_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="--cpu"):
        module.main([])


def test_tools_run_as_modules():
    """``python -m wayverb_tpu_torch.tools.<name>`` runs the tool."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "wayverb_tpu_torch.tools.level_match",
         "--cpu", "--distance", "1.5"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("distance 1.5 m: in-band |P|/geometric")
