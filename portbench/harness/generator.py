"""The one traffic generator: every draw of a run comes from its seed.

A traffic file names its kind (``kinds/<kind>.py``) and its parameters;
this module turns them, the configuration's room and the seed into the
requests of a closed loop.  Every seed gives the same sizes and the same
work (each render the same grid and steps), only other positions and
targets.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.harness import scenes


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed (any whole number, however
    large)."""
    return np.random.default_rng([stream, abs(int(seed)), int(seed < 0)])


def _box_distance(p, lo, hi) -> float:
    d = np.maximum(np.maximum(np.asarray(lo) - p, p - np.asarray(hi)), 0.0)
    return float(np.sqrt((d ** 2).sum()))


def positions(config: dict, traffic: dict, seed: int):
    """Endless (source, receiver) pairs inside the room: at least
    ``wall_margin_m`` from every wall and column and
    ``min_separation_m`` apart."""
    (lo, hi), cols = scenes.boxes(config)
    margin = traffic["wall_margin_m"]
    lo = np.asarray(lo) + margin
    hi = np.asarray(hi) - margin
    g = rng(seed, 1)

    def point():
        while True:
            p = lo + g.random(3) * (hi - lo)
            if all(_box_distance(p, c_lo, c_hi) >= margin
                   for c_lo, c_hi in cols):
                return p

    while True:
        src, rcv = point(), point()
        if np.linalg.norm(src - rcv) >= traffic["min_separation_m"]:
            yield tuple(float(v) for v in src), tuple(float(v) for v in rcv)


def mesh_rate(config: dict) -> float:
    """The waveguide's sample rate: cutoff / (0.25 usable portion)."""
    wg = config["waveguide"]
    return wg["cutoff_hz"] / (0.25 * wg["usable_portion"])


def simulation_time(config: dict, fs_mesh: float) -> float:
    """The IR length to ask for: ``ir_seconds``, or ``ir_steps`` as a time
    that rounds up to exactly that many steps."""
    if "ir_steps" in config:
        return (config["ir_steps"] - 0.5) / fs_mesh
    return float(config["ir_seconds"])


def steps(fs_mesh: float, sim_time: float) -> int:
    return int(math.ceil(fs_mesh * sim_time))


def target_absorption(traffic: dict, seed: int, bands: int) -> np.ndarray:
    """The fit target's absorption, one value in the traffic's range on
    every band."""
    a, b = traffic["target_absorption"]
    return np.full(bands, a + (b - a) * rng(seed, 2).random())


def impulse(config: dict, spacing: float, num_steps: int) -> np.ndarray:
    """The calibrated unit impulse: sqrt(Z / 4 pi) / (0.3405 spacing) at
    step 0."""
    z = config["environment"]["acoustic_impedance"]
    sig = np.zeros(num_steps, dtype=np.float32)
    sig[0] = math.sqrt(z / (4 * math.pi)) / (0.3405 * spacing)
    return sig


def sample(seed: int, count: int, k: int) -> list:
    """``k`` of ``count`` completed requests, drawn from the seed."""
    k = min(k, count)
    return sorted(int(i) for i in rng(seed, 3).choice(count, k,
                                                      replace=False))
