"""What the harness and the reference load: no module whose top-level name,
compared whole, is jax, jaxlib or wayverb_tpu; and the reference loads
nothing of wayverb_tpu_torch."""

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

RUN_SMALL = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench import run
from portbench.harness import device, manifest
from portbench.tests import small
m = manifest.manifest()
for name in [p["name"] for p in m["per_layer"]]:
    manifest.module("metrics", name)
for name in ("peaks", "b2", "b6", "b7", "b8"):
    manifest.module("rooflines", name)
cfg = small.shoebox()
r = run.run_cell(torch, cfg, small.traffic("wg"),
                 manifest.limits("shoebox_hall.wg"), [],
                 manifest.end_to_end(m, "shoebox_hall.wg"), 1, 10.0, 0,
                 device="cpu")
print(json.dumps(sorted(set(k.split(".")[0] for k in sys.modules))))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.waveguide, portbench.reference.filters
print(json.dumps(sorted(set(k.split(".")[0] for k in sys.modules))))
"""


def _top_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax():
    names = _top_names(RUN_SMALL)
    assert "wayverb_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "wayverb_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "wayverb_tpu",
                        "wayverb_tpu_torch"}


def test_forbidden_check_compares_whole_names():
    from portbench.harness import device
    before = set(sys.modules)
    sys.modules["wayverb_tpu_torch_probe_name"] = object()
    sys.modules["jaxlib.fake"] = object()
    try:
        found = device.forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]
    assert "jaxlib.fake" in found
    assert "wayverb_tpu_torch_probe_name" not in found
