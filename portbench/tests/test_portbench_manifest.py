"""BENCHMARK.json and every file it names load by name, and agree."""

import json
import re

import pytest

from portbench.harness import manifest

M = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_loads(c):
    cfg = manifest.config(c["name"])
    assert cfg["name"] == c["name"]
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert all(k in cfg for k in c["reduced"])
    assert cfg["precision"] == "float32"
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == c["name"] for w in M["workloads"])


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    manifest.config(w["config"])
    t = manifest.traffic(w["traffic"])
    assert t["name"] == w["traffic"]
    kind = manifest.module("kinds", t["kind"])
    assert all(callable(getattr(kind, f)) for f in
               ("inputs", "Cell", "numbers", "control"))
    limits = manifest.limits(w["name"])
    assert all("limit" in v for v in limits.values())
    e2e = manifest.end_to_end(M, w["name"])
    assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2
    assert manifest.per_layer(M, w["name"])


@pytest.mark.parametrize("p", M["per_layer"], ids=lambda p: p["name"])
def test_metric_reader_loads(p):
    mod = manifest.module("metrics", p["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        p["layer"], p["unit"], p["source"], p["moves"])
    assert p["moves"] in {e["name"] for e in M["end_to_end"]}
    for cell in p["workloads"]:
        assert p["moves"] in {e["name"] for e in
                              manifest.end_to_end(M, cell)}
    assert mod.read({"timings": {}}) is None


@pytest.mark.parametrize("e", M["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_reader_loads(e):
    assert callable(manifest.module("end_to_end", e["name"]).read)


@pytest.mark.parametrize("path", sorted(
    p for d in ("kinds", "end_to_end", "metrics", "rooflines")
    for p in (manifest.BENCH / d).glob("*.py")), ids=lambda p: p.name)
def test_every_file_loads_by_its_name(path):
    """Also the files of a cell kept for later (the columns hall's): each
    loads by the name the manifest would give it, and a per-layer metric
    moves an end-to-end metric that has a file."""
    mod = manifest.module(path.parent.name, path.name[:-3])
    if path.parent.name == "metrics":
        assert (manifest.BENCH / "end_to_end" / f"{mod.MOVES}.py").exists()
        assert mod.read({"timings": {}}) is None


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert all(UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
               for x in metrics)
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    setup = next(e for e in M["end_to_end"] if e["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


@pytest.mark.parametrize("name", ["peaks", "b2", "b6", "b7", "b8"])
def test_roofline_loads(name):
    mod = manifest.module("rooflines", name)
    if name == "peaks":
        assert mod.bound_us(3.35e12, 0)[0] == pytest.approx(1e6)
    else:
        ops, nbytes = mod.launch({"dims": (8, 9, 10), "order": 6, "taps": 7,
                                  "chunk": 4})
        assert ops > 0 and nbytes > 0 and mod.KERNEL.endswith("_kernel")
