"""Window functions and sinc kernels.

Port of ``wayverb_tpu.signal.windows``.

Parity: reference ``core/sinc.h`` (unwindowed sinc kernel, blackman,
hanning/left-hanning, windowed_sinc_kernel with blackman).
"""

from __future__ import annotations

import math

import torch


def sinc(t):
    """sin(πt)/(πt) with sinc(0)=1."""
    return torch.sinc(t)


def _offsets(length: int, device):
    return torch.arange(length, dtype=torch.float32, device=device) \
        / (length - 1.0)


def sinc_kernel(cutoff, length: int, device="cpu"):
    """Lowpass sinc kernel (length odd, normalized cutoff 0..0.5)."""
    if length % 2 == 0:
        raise ValueError("sinc kernel length must be odd")
    i = torch.arange(length, dtype=torch.float32, device=device)
    return sinc(2.0 * cutoff * (i - (length - 1) / 2.0))


def blackman(length: int, device="cpu"):
    a0, a1, a2 = 7938.0 / 18608.0, 9240.0 / 18608.0, 1430.0 / 18608.0
    offset = _offsets(length, device)
    return (a0 - a1 * torch.cos(2.0 * math.pi * offset)
            + a2 * torch.cos(4.0 * math.pi * offset))


def hanning(length: int, device="cpu"):
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * _offsets(length, device))


def left_hanning(length: int, device="cpu"):
    """Rising half of a hann window (reference ``core::left_hanning``)."""
    return 0.5 - 0.5 * torch.cos(math.pi * _offsets(length, device))


def right_hanning(length: int, device="cpu"):
    return 0.5 + 0.5 * torch.cos(math.pi * _offsets(length, device))


def windowed_sinc_kernel(cutoff, length: int, device="cpu"):
    return sinc_kernel(cutoff, length, device) * blackman(length, device)
