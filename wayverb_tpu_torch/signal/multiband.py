"""Band edges, crossover envelopes and zero-phase FFT filtering.

Port of the part of ``wayverb_tpu.signal.multiband`` that the waveguide leg
needs: band centres/edges (numpy, setup path), the antoni2010 lowpass /
highpass / bandpass magnitudes and ``apply_zero_phase_magnitude`` on
``torch.fft``.  The HRTF mixdown and per-band energy wait for the ray leg.

Parity: reference ``frequency_domain/envelope.h`` + ``src/envelope.cpp``
(antoni2010 eq. 19/20 band-edge envelopes, logarithmic band edges),
``frequency_domain/multiband_filter.h`` (FFT length = 4·next_pow2),
``hrtf/multiband.h:11`` (audible range 20 Hz – 20 kHz, 8 bands).
"""

from __future__ import annotations

import math

import numpy as np
import torch

AUDIBLE_RANGE = (20.0, 20000.0)
DEFAULT_BANDS = 8


def band_edge_frequency(band, bands, lo, hi):
    """Logarithmically spaced edge ``band`` of ``bands`` bands over [lo, hi]."""
    return lo * (hi / lo) ** (band / bands)


def band_edges(bands: int = DEFAULT_BANDS, lo=AUDIBLE_RANGE[0],
               hi=AUDIBLE_RANGE[1]) -> np.ndarray:
    """(bands+1,) edges in Hz (numpy, setup path)."""
    return np.asarray(
        [band_edge_frequency(i, bands, lo, hi) for i in range(bands + 1)])


def band_centres(bands: int = DEFAULT_BANDS, lo=AUDIBLE_RANGE[0],
                 hi=AUDIBLE_RANGE[1]) -> np.ndarray:
    """(bands,) geometric band centres in Hz (numpy, setup path)."""
    return np.asarray([band_edge_frequency(2 * i + 1, 2 * bands, lo, hi)
                       for i in range(bands)])


def _band_edge_impl(p, width, l: int):
    x = (p / width + 1.0) * 0.5
    for _ in range(l):
        x = torch.sin(math.pi * x / 2.0)
    return x


def lower_band_edge(p, width, l: int = 0):
    """Rising crossover envelope: 0 below -width, 1 above +width (power)."""
    return torch.square(torch.sin(math.pi * _band_edge_impl(p, width, l) / 2.0))


def upper_band_edge(p, width, l: int = 0):
    return torch.square(torch.cos(math.pi * _band_edge_impl(p, width, l) / 2.0))


def compute_lopass_magnitude(frequency, edge, width, l: int = 0):
    """Smooth zero-phase lowpass magnitude (frequencies normalized alike)."""
    absolute_width = edge * width
    p = frequency - edge
    one = torch.ones_like(frequency)
    zero = torch.zeros_like(frequency)
    return torch.where(
        frequency < edge - absolute_width, one,
        torch.where(frequency < edge + absolute_width,
                    upper_band_edge(p, absolute_width, l), zero))


def compute_hipass_magnitude(frequency, edge, width, l: int = 0):
    absolute_width = edge * width
    p = frequency - edge
    one = torch.ones_like(frequency)
    zero = torch.zeros_like(frequency)
    return torch.where(
        frequency < edge - absolute_width, zero,
        torch.where(frequency < edge + absolute_width,
                    lower_band_edge(p, absolute_width, l), one))


def compute_bandpass_magnitude(frequency, lo, hi, width, l: int = 0):
    return compute_lopass_magnitude(frequency, hi, width, l) * \
        compute_hipass_magnitude(frequency, lo, width, l)


def best_fft_length(n: int) -> int:
    """4 × next power of two — extra padding so edge discontinuities decay."""
    return (1 << math.ceil(math.log2(max(n, 1)))) << 2


def _fft_freqs(bins: int, dtype, device) -> torch.Tensor:
    """Normalized frequency (0..0.5..) for rfft bins of a ``bins``-pt FFT."""
    return torch.arange(bins // 2 + 1, dtype=dtype, device=device) / bins


def apply_zero_phase_magnitude(signal, mag_fn):
    """FFT → multiply rfft bins by ``mag_fn(normalized_freq)`` → IFFT.

    ``signal``: (..., n).  Returns the same length (zero-phase, no delay).
    """
    n = signal.shape[-1]
    bins = best_fft_length(n)
    spectrum = torch.fft.rfft(signal, n=bins, dim=-1)
    mags = mag_fn(_fft_freqs(bins, torch.float32, signal.device))
    filtered = torch.fft.irfft(spectrum * mags, n=bins, dim=-1)
    return filtered[..., :n]
