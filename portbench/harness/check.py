"""What every kind's correctness check shares: the plain reference's room
(``reference/<config's reference>.py``, built from the same inputs the
program got), the gap of an output from the reference's, and the judgement
of each number against its limit in ``limits/<cell>.json``.  What a kind
compares is in ``kinds/<kind>.py``.
"""

from __future__ import annotations

import importlib

import numpy as np

from portbench.harness import scenes


def gap(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max()
                 / max(float(np.abs(want).max()), 1e-30))


def reference_room(torch, config, fs, device):
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    shell, cols = scenes.boxes(config)
    env = config["environment"]
    return ref, ref.build_room(shell, cols, config["absorption"], fs,
                               env["speed_of_sound"], device)


def judge(numbers: dict, limits: dict):
    """(correct, [[name, value, limit], ...]): every number at or under its
    limit (a NaN is over)."""
    rows = []
    ok = True
    for name, value in numbers.items():
        limit = limits[name]["limit"]
        good = value <= limit
        ok = ok and bool(good)
        rows.append([name, value, limit])
    return ok, rows
