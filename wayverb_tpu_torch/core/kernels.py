"""Excitation signal kernels for the waveguide source.

Port of ``wayverb_tpu.core.kernels``.  The pulse shapes are elementwise
torch functions; the ``gen_*`` generators sample them at unit rate on
``device``.

Parity: reference ``core/kernel.h:11-60`` + ``core/src/kernel.cpp``
(gaussian / sin-modulated gaussian / gaussian-dash with σ = 1/(2π f_c) and
delay ⌈8σ⌉; ricker with delay ⌈1/f_c⌉).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian(t, sigma):
    return torch.exp(-(t * t) / (2.0 * sigma * sigma))


def sin_modulated_gaussian(t, sigma):
    return -gaussian(t, sigma) * torch.sin(t / sigma)


def gaussian_dash(t, sigma):
    return -t * gaussian(t, sigma) / (sigma * sigma)


def ricker(t, f):
    u = torch.square(math.pi * f * t)
    return (1.0 - 2.0 * u) * torch.exp(-u)


def _taps(delay: int, device):
    return torch.arange(2 * delay + 1, dtype=torch.float32,
                        device=device) - delay


def _gauss_like(fc: float, func, device):
    sigma = 1.0 / (2.0 * math.pi * fc)
    delay = int(math.ceil(8.0 * sigma))
    return func(_taps(delay, device), sigma)


def gen_gaussian(fc: float, *, device):
    """Gaussian pulse sampled at unit rate; ``fc`` is normalized frequency."""
    return _gauss_like(fc, gaussian, device)


def gen_sin_modulated_gaussian(fc: float, *, device):
    return _gauss_like(fc, sin_modulated_gaussian, device)


def gen_gaussian_dash(fc: float, *, device):
    return _gauss_like(fc, gaussian_dash, device)


def gen_ricker(fc: float, *, device):
    delay = int(math.ceil(1.0 / fc))
    return ricker(_taps(delay, device), fc)


# LFSR feedback taps (Fibonacci form) yielding maximal periods 2^order − 1.
_MLS_TAPS = {
    2: (2, 1), 3: (3, 2), 4: (4, 3), 5: (5, 3), 6: (6, 5), 7: (7, 6),
    8: (8, 6, 5, 4), 9: (9, 5), 10: (10, 7), 11: (11, 9),
    12: (12, 11, 10, 4), 13: (13, 12, 11, 8), 14: (14, 13, 12, 2),
    15: (15, 14), 16: (16, 15, 13, 4), 17: (17, 14), 18: (18, 11),
    19: (19, 18, 17, 14), 20: (20, 17),
}


def generate_maximum_length_sequence(order: int) -> np.ndarray:
    """±1 maximum-length sequence of length 2^order − 1 (float32 numpy,
    integer-exact; host data, like the reference's).

    Parity: reference ``core::generate_maximum_length_sequence`` as used by
    ``bin/solution_growth/solution_growth.cpp`` (make_mls) to probe the mesh
    for unstable solution growth with a broadband flat-spectrum input.
    """
    if order not in _MLS_TAPS:
        raise ValueError(f"MLS order {order} unsupported (2..20)")
    taps = _MLS_TAPS[order]
    state = np.ones(order, dtype=np.int8)
    n = (1 << order) - 1
    out = np.empty(n, dtype=np.float32)
    for i in range(n):
        out[i] = 2.0 * state[-1] - 1.0
        fb = 0
        for t in taps:
            fb ^= int(state[t - 1])
        state[1:] = state[:-1]
        state[0] = fb
    return out
