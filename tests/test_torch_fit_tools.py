"""The port's long-run, boundary-fit and HRTF-bake tools
(``wayverb_tpu_torch/tools``: ``longrun``, ``boundary_fit_sweep``,
``bake_hrtf``) against the reference's scripts (``tools/``), on the CPU.

Tolerances:
 * ``longrun``: ``build`` + ``run_waveguide_box`` of both packages at
   (24, 24, 32) for 300 steps within 2e-5 of peak (the drift XLA's fused
   multiply-adds leave on a long recurrence, ROADMAP §C); ``mode_f64`` at
   400 steps, peak and drift rtol 1e-3, both runs stable.  The reference
   pins ``mode_f64`` to the CPU with x64 on, a process-wide switch, so its
   runs are made in a child process (``F64_CHILD``).
 * ``boundary_fit_sweep``: host numpy in both packages, every row's
   numbers rtol 1e-12 against the reference's and at the precision
   ``BOUNDARY_FIT_r04.json`` stores (its floats' full ``repr``: rtol 1e-12).
 * ``bake_hrtf``: the tables rtol 1e-6 (float32 FFTs in both); the
   reference's ``TestBake`` checks hold on the port's table through the
   port's ``table_from_energies`` and ``Hrtf``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wayverb_tpu_torch.utils.audio import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100.0

torch.set_num_threads(2)


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------------
# longrun

def test_longrun_build_and_run_match():
    """The same mesh, source and receiver nodes; the receiver traces within
    2e-5 of peak over 300 steps."""
    from wayverb_tpu.waveguide.run import run_waveguide_box as j_run
    from wayverb_tpu_torch.tools import longrun
    from wayverb_tpu_torch.waveguide.run import run_waveguide_box
    ref = _reference_module("longrun")
    side, steps = (24, 24, 32), 300
    j_mesh, j_src, j_rcv = ref.build(side, steps)
    mesh, src, rcv = longrun.build(side, steps, device="cpu")
    assert tuple(mesh.descriptor.dimensions) == tuple(
        j_mesh.descriptor.dimensions)
    assert src.node_idx == int(j_src.node_idx)
    assert int(rcv.node_idx) == int(j_rcv.node_idx)
    np.testing.assert_array_equal(src.signal.numpy(),
                                  np.asarray(j_src.signal))
    want = j_run(j_mesh.structure, j_mesh.box_spec, j_src, j_rcv, steps)
    got = run_waveguide_box(mesh.structure, mesh.box_spec, src, rcv, steps)
    w = np.asarray(want["outputs"])
    peak = np.abs(w).max()
    assert peak > 0 and bool(got["stable"]) and bool(want["stable"])
    np.testing.assert_allclose(got["outputs"].numpy(), w, rtol=0,
                               atol=2e-5 * peak)


# The reference's ``mode_f64`` switches x64 on and then calls ``build``,
# whose box corners are then float64: that mesh is (31, 31, 128), where
# ``build`` without x64 (and the port's, whose ``Box`` is float32) gives
# (32, 32, 128).  So the child builds the reference's mesh with x64 off,
# then switches it on for ``mode_f64``'s two runs and its numbers.
F64_CHILD = """
import json, runpy, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
m = runpy.run_path(sys.argv[1])
steps = int(sys.argv[2])
mesh, source, receiver = m["build"]((32, 32, 128), steps, absorption=0.05)
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from wayverb_tpu.waveguide.run import run_waveguide_box
o32 = run_waveguide_box(mesh.structure, mesh.box_spec, source, receiver,
                        steps)
o64 = run_waveguide_box(mesh.structure, mesh.box_spec, source, receiver,
                        steps, state_dtype=jnp.float64)
p32, p64 = np.asarray(o32["outputs"]), np.asarray(o64["outputs"])
scale, drift = float(np.abs(p64).max()), float(np.abs(p32 - p64).max())
print(json.dumps({"dims": list(mesh.descriptor.dimensions), "peak": scale,
                  "max_drift": drift, "rel_drift": drift / scale,
                  "stable32": bool(o32["stable"]),
                  "stable64": bool(o64["stable"])}))
"""


def test_longrun_f64(tmp_path):
    """``--mode f64 --steps 400``: peak and drift rtol 1e-3, both stable,
    against the reference's two runs on the same mesh (``F64_CHILD``, with
    ``--xla_cpu_max_isa=AVX``: the drift is the float32 run's rounding,
    which XLA's fused multiply-adds change); the ``--json`` record."""
    from wayverb_tpu_torch.tools import longrun
    proc = subprocess.run(
        [sys.executable, "-c", F64_CHILD,
         os.path.join(ROOT, "tools", "longrun.py"), "400"], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_cpu_max_isa=AVX"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    assert want["dims"] == [32, 32, 128]
    path = str(tmp_path / "longrun.json")
    got = longrun.main(["--mode", "f64", "--steps", "400", "--cpu",
                        "--json", path])
    assert got["stable32"] and got["stable64"]
    assert want["stable32"] and want["stable64"]
    assert (got["mode"], got["steps"], got["shape"], got["bound"]) == (
        "f64", 400, [32, 32, 128], 2e-3)
    for key in ("peak", "max_drift", "rel_drift"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    with open(path) as f:
        assert json.load(f) == [got]


def test_longrun_json_replaces_its_mode(tmp_path):
    """``--json`` keeps the records of the other mode and replaces its
    own."""
    from wayverb_tpu_torch.tools import longrun
    path = tmp_path / "records.json"
    path.write_text(json.dumps([{"mode": "hw", "steps": 1},
                                {"mode": "f64", "steps": 2}]))
    got = longrun.main(["--mode", "f64", "--steps", "40", "--cpu",
                        "--json", str(path)])
    assert json.loads(path.read_text()) == [{"mode": "hw", "steps": 1}, got]


# --------------------------------------------------------------------------
# boundary_fit_sweep

def _rows_close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("material", "mesh_rate_hz", "bands_in_range"):
            assert g[key] == w[key]
        for key in ("max_inband_r_error", "max_reflectance"):
            assert g[key] == pytest.approx(w[key], rel=rel), (g, w)


def test_boundary_fit_sweep(capsys, tmp_path):
    """Every row against the reference's, and against the committed
    ``BOUNDARY_FIT_r04.json``; the printed line and the summary."""
    from wayverb_tpu_torch.tools import boundary_fit_sweep
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path / "p.json")
    capsys.readouterr()
    _reference_module("boundary_fit_sweep").main(ref_path)
    want_lines = capsys.readouterr().out.splitlines()
    got = boundary_fit_sweep.main(["--json", port_path])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [want_lines[0], f"wrote {port_path}"]
    with open(ref_path) as f:
        want = json.load(f)
    with open(port_path) as f:
        assert json.load(f) == got
    _rows_close(got["rows"], want["rows"], 1e-12)
    for key in ("materials", "mesh_rates", "error_bound", "passivity_bound"):
        assert got[key] == want[key]
    for key in ("worst_inband_r_error", "worst_reflectance"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    with open(os.path.join(ROOT, "BOUNDARY_FIT_r04.json")) as f:
        committed = json.load(f)
    _rows_close(got["rows"], committed["rows"], 1e-12)
    assert got["worst_reflectance"] <= committed["passivity_bound"] + 1e-6
    assert got["worst_inband_r_error"] <= committed["error_bound"]


# --------------------------------------------------------------------------
# bake_hrtf

def synth_hrir_set(directory):
    """Stereo HRIRs over a coarse az/el grid with physical ILD (right ear
    louder for sources on the right) and ITD (right ear earlier); a copy of
    ``tests/test_hrtf_bake.py``'s."""
    half_head_s = 0.0009            # ~0.31 m path difference at extremes
    for az in range(0, 360, 30):
        for el in (-40, 0, 40):
            rad = np.radians(az)
            lateral = np.sin(rad) * np.cos(np.radians(el))  # +1 = right
            n = 512
            ir = np.zeros((2, n), np.float64)
            for ch, side in ((0, -1.0), (1, 1.0)):
                gain = 1.0 + 0.6 * lateral * side           # ILD
                delay_s = half_head_s * (1.0 - lateral * side) / 2  # ITD
                k = int(round(delay_s * SR)) + 8
                ir[ch, k] = gain
                ir[ch, k + 1] = 0.3 * gain                  # small tail
            write_wav(os.path.join(directory,
                                   f"azel_az_{az}_el_{el}.wav"), ir, SR)


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """(the port's table, its file, the reference's table)."""
    from wayverb_tpu_torch.tools.bake_hrtf import bake
    d = tmp_path_factory.mktemp("hrirs")
    synth_hrir_set(str(d))
    out = str(d / "table.npz")
    table = bake(str(d), out, verbose=False)
    want = _reference_module("bake_hrtf").bake(str(d), str(d / "ref.npz"),
                                               verbose=False)
    return table, out, want


def test_bake_matches_reference(baked):
    table, out, want = baked
    assert table.shape == want.shape == (24, 9, 2, 8)
    np.testing.assert_allclose(table, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.load(out)["table"], table)


def test_bake_coverage_ild_and_symmetry(baked):
    """``TestBake``'s checks on the port's table: 12 azimuths × 3
    elevations filled; the right ear louder for a source on the right and
    the left for one on the left; a frontal source symmetric."""
    table, _, _ = baked
    assert (table.sum(axis=(2, 3)) > 0).sum() == 12 * 3
    az90, az270, mid = int(round(90 / 360 * 24)), int(round(270 / 360 * 24)), \
        9 // 2
    assert np.all(table[az90, mid, 1] > table[az90, mid, 0])
    assert np.all(table[az270, mid, 0] > table[az270, mid, 1])
    np.testing.assert_allclose(table[0, mid, 0], table[0, mid, 1], rtol=1e-5)


def test_hrtf_consumes_the_baked_table(baked):
    """Through ``table_from_energies`` and ``Hrtf``: the right ear's gain
    above the left's for a direction to the right, every band."""
    from wayverb_tpu_torch.core.attenuator import Hrtf
    from wayverb_tpu_torch.core.hrtf import table_from_energies
    table, _, _ = baked
    t = table_from_energies(table)
    inc = torch.tensor([[1.0, 0.0, 0.0]])
    g_r = Hrtf(channel=1, table=t).attenuation(inc)[0].numpy()
    g_l = Hrtf(channel=0, table=t).attenuation(inc)[0].numpy()
    assert np.all(g_r > g_l)


def test_bake_reads_listen_names(tmp_path, capsys):
    """IRCAM Listen names land in the reference's bins (P315 = −45°) and a
    name without az/el is skipped with the reference's line; ``main``."""
    from wayverb_tpu_torch.tools import bake_hrtf
    d = tmp_path / "listen"
    d.mkdir()
    for az, el_p in ((30, 45), (330, 315), (0, 0)):
        ir = np.zeros((2, 256))
        for ch, side in ((0, -1.0), (1, 1.0)):
            ir[ch, 8] = 1.0 + 0.6 * np.sin(np.radians(az)) * side
        write_wav(str(d / f"IRC_1002_C_R0195_T{az:03d}_P{el_p:03d}.wav"), ir,
                  SR)
    write_wav(str(d / "readme.wav"), np.zeros((2, 16)), SR)
    capsys.readouterr()
    report = bake_hrtf.main([str(d), str(d / "t.npz"), "--az-bins", "12"])
    assert capsys.readouterr().out.splitlines() == [
        "skipping readme.wav: no az/el in filename",
        "baked 3/108 direction bins", f"wrote {d / 't.npz'}"]
    assert report == {"baked_bins": 3, "bins": 108,
                      "wrote": str(d / "t.npz")}
    table = np.load(d / "t.npz")["table"]
    assert table[1, 9 // 2 + 2].sum() > 0        # T030_P045
    assert table[11, 9 // 2 - 2].sum() > 0       # T330_P315
    assert table[0, 9 // 2].sum() > 0            # T000_P000
    az30 = table[1, 9 // 2 + 2]
    assert az30[1].sum() > az30[0].sum()
    want = _reference_module("bake_hrtf").bake(str(d), str(tmp_path / "r.npz"),
                                               az_bins=12, verbose=False)
    np.testing.assert_allclose(table, want, rtol=1e-6, atol=0)
