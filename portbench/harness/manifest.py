"""Everything the harness runs, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), whose ``kind`` names the loop and the check it
runs (``kinds/<kind>.py``); an end-to-end metric is
``end_to_end/<name>.py`` and a per-layer metric ``metrics/<name>.py``; a
kernel's operations and bytes are ``rooflines/<name>.py``; the limits of a
cell's correctness check are ``limits/<cell>.json``; a configuration's plain
reference is ``reference/<name>.py``.  Adding any of them needs no edit
here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    key = f"portbench_{kind}_{name}".replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(m: dict, cell_name: str) -> list:
    return [e for e in m["end_to_end"] if _applies(e, cell_name)]


def per_layer(m: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {e["name"] for e in end_to_end(m, cell_name)}
    return [p for p in m["per_layer"]
            if (cell_name in p["workloads"] if "workloads" in p
                else p["moves"] in e2e)]
