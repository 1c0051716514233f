"""Advanced source excitation design: transparent sources and the
physically-constrained (PCS) source.

Port of ``wayverb_tpu.waveguide.excitation``: float64 numpy on the host, as
there (the designed signal is handed to a source as a tensor afterwards).

Parity:
 * mesh intrinsic impulse response — the reference precomputes it with an
   auxiliary folded "compressed" waveguide
   (``compensation_signal/lib/src/waveguide.cpp:103-107``); here we run the
   actual free-field mesh directly (information travels ≤1 cell/step on the
   rectilinear lattice, so a grid of radius steps+2 is exactly free-field).
 * transparent source — deconvolve the input by the mesh IR
   (``src/make_transparent.cpp:10-30``: windowed IR, convolve, subtract).
 * PCS source — sheaffer2014: maxflat FIR pulse (f0=0.075, N=16,
   A=0.00025) → pulsating-sphere mechanical biquad → g0 gain → injection
   differentiator biquad (``src/pcs.cpp``, ``include/waveguide/pcs.h``).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from wayverb_tpu_torch.waveguide.descriptor import grid_spacing


# ---------------------------------------------------------------------------
# mesh intrinsic impulse response + transparent source

@functools.lru_cache(maxsize=4)
def mesh_impulse_response(num_steps: int = 128) -> np.ndarray:
    """Pressure at the source node of a free-field mesh fed a unit impulse.

    Runs the plain interior update on a grid big enough that edge
    reflections cannot reach the centre within ``num_steps``.
    """
    r = num_steps // 2 + 2
    side = 2 * r + 1
    cur = np.zeros((side, side, side), dtype=np.float64)
    prev = np.zeros_like(cur)
    centre = (r, r, r)
    out = np.zeros(num_steps)
    cur[centre] = 1.0
    for t in range(num_steps):
        # the reference's compensation tool records one step AFTER each
        # injection, so its stored IR is [0, h1, h2, ...] — the
        # instantaneous sample h0 is excluded; match that layout
        out[t] = 0.0 if t == 0 else cur[centre]
        total = np.zeros_like(cur)
        total[:-1] += cur[1:]
        total[1:] += cur[:-1]
        total[:, :-1] += cur[:, 1:]
        total[:, 1:] += cur[:, :-1]
        total[:, :, :-1] += cur[:, :, 1:]
        total[:, :, 1:] += cur[:, :, :-1]
        nxt = total / 3.0 - prev
        prev, cur = cur, nxt
    return out


def right_hanning(n: int) -> np.ndarray:
    offset = np.arange(n) / (n - 1.0)
    return 0.5 + 0.5 * np.cos(np.pi * offset)


def make_transparent(signal, ir_steps: int = 128) -> np.ndarray:
    """Deconvolve ``signal`` by the mesh IR so it propagates unchanged.

    Returns len(signal) + ir_steps − 1 samples (the correction tail).
    """
    signal = np.asarray(signal, dtype=np.float64)
    ir = mesh_impulse_response(ir_steps) * right_hanning(ir_steps)
    convolved = np.convolve(signal, ir)
    out = -convolved
    out[:signal.size] += signal
    return out


# ---------------------------------------------------------------------------
# PCS (sheaffer2014)

def factdbl(t: float) -> float:
    out = 1.0
    i = t
    while i >= 1:
        out *= i
        i -= 2
    return out


def maxflat(f0: float, n: int, amplitude: float, h_len: int
            ) -> Tuple[np.ndarray, int]:
    """Maximally-flat FIR lowpass pulse; returns (signal, offset)."""
    h = np.zeros(h_len)
    q = 2 * n - 1
    for k in range(-q, q + 1):
        if k == 0:
            continue
        top = factdbl(q) ** 2 * math.sin(k * 2.0 * math.pi * f0)
        bot = k * factdbl(2 * n + k - 1) * factdbl(2 * n - k - 1)
        h[k + q] = top / (bot * (2.0 if k % 2 != 0 else math.pi))
    h[q] = 2.0 * f0
    scale = amplitude / np.abs(h).max()
    return h * scale, n * 2


def compute_g0(acoustic_impedance: float, speed_of_sound: float,
               sample_rate: float, radius: float) -> float:
    courant_sq = 1.0 / 3.0
    density = acoustic_impedance / speed_of_sound
    area = 4.0 * math.pi * radius * radius
    dx = grid_spacing(speed_of_sound, 1.0 / sample_rate)
    return courant_sq * density * area / dx


def mech_sphere(mass: float, f0_norm: float, q: float, period: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pulsating-sphere mechanical biquad (b, a) with a[0]=1."""
    fs = 1.0 / period
    w0 = 2.0 * math.pi * f0_norm * fs
    k = mass * w0 * w0
    r = w0 * mass / q
    beta = w0 / math.tan(w0 * period / 2.0)
    den = mass * beta * beta + r * beta + k
    b0 = beta / den
    a1 = (2.0 * (k - mass * beta * beta)) / den
    a2 = 1.0 - (2.0 * r * beta / den)
    return np.asarray([b0, 0.0, -b0]), np.asarray([1.0, a1, a2])


def _biquad_filter(b, a, x):
    y = np.zeros_like(x)
    z1 = z2 = 0.0
    for i, xn in enumerate(x):
        yn = b[0] * xn + z1
        z1 = b[1] * xn - a[1] * yn + z2
        z2 = b[2] * xn - a[2] * yn
        y[i] = yn
    return y


def design_pcs_source(length: int, acoustic_impedance: float,
                      speed_of_sound: float, sample_rate: float,
                      radius: float, sphere_mass: float,
                      low_cutoff_hz: float, low_q: float
                      ) -> Tuple[np.ndarray, int]:
    """Full PCS chain; returns (signal, offset).  Use as a SOFT source."""
    signal, offset = maxflat(0.075, 16, 0.00025, length)
    mb, ma = mech_sphere(sphere_mass, low_cutoff_hz / sample_rate, low_q,
                         1.0 / sample_rate)
    signal = _biquad_filter(mb, ma, signal)
    signal = signal * compute_g0(acoustic_impedance, speed_of_sound,
                                 sample_rate, radius)
    half_fs = sample_rate / 2.0
    signal = _biquad_filter(np.asarray([half_fs, 0.0, -half_fs]),
                            np.asarray([1.0, 0.0, 0.0]), signal)
    return signal, offset
