"""Band edges, crossover envelopes and zero-phase FFT filtering.

Port of ``wayverb_tpu.signal.multiband``: band centres/edges (numpy, setup
path), the antoni2010 lowpass / highpass / bandpass magnitudes,
``apply_zero_phase_magnitude`` on ``torch.fft``, and the 8-band filter and
mixdown the geometric solvers' IRs go through (all bands in one FFT
batch).  ``per_band_energy`` waits for the slice that needs it.

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


def max_width_factor(lo, hi, step):
    base = (hi / lo) ** step
    return (base - 1.0) / (base + 1.0)


def width_factor(lo, hi, bands, overlap):
    """Relative crossover half-width shared by all edges (antoni2010)."""
    return max_width_factor(lo, hi, 1.0 / bands) * overlap


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


def multiband_params(sample_rate, bands: int = DEFAULT_BANDS, overlap=1.0):
    """Normalized band edges (cycles/sample) + width factor for the audible
    range."""
    edges = band_edges(bands) / sample_rate
    wf = width_factor(AUDIBLE_RANGE[0], AUDIBLE_RANGE[1], bands, overlap)
    return edges, wf


def multiband_filter(signals, sample_rate, bands: int = DEFAULT_BANDS,
                     l: int = 0):
    """Bandpass each band of (..., bands, n) with its own antoni2010 window.

    All bands share one FFT batch; returns filtered (..., bands, n).
    """
    edges, wf = multiband_params(sample_rate, bands)
    n = signals.shape[-1]
    bins = best_fft_length(n)
    freqs = _fft_freqs(bins, torch.float32, signals.device)     # (F,)
    e = torch.as_tensor(edges, dtype=torch.float32, device=signals.device)
    mags = compute_bandpass_magnitude(freqs[None, :], e[:-1, None],
                                      e[1:, None], wf, l)       # (bands, F)
    spectrum = torch.fft.rfft(signals, n=bins, dim=-1)
    filtered = torch.fft.irfft(spectrum * mags, n=bins, dim=-1)
    return filtered[..., :n]


def multiband_filter_and_mixdown(signals, sample_rate,
                                 bands: int = DEFAULT_BANDS):
    """8-band signal (..., bands, n) → bandpass each band → sum → (..., n).

    Parity: ``core/mixdown.h:11-24``.
    """
    return torch.sum(multiband_filter(signals, sample_rate, bands), dim=-2)


def per_band_energy(signal, sample_rate, bands: int = DEFAULT_BANDS):
    """RMS energy of ``signal`` (..., n) measured in each band.

    Parity: ``frequency_domain::per_band_energy`` (normalized rms: the
    filtered energy divided by the integrated envelope area).
    """
    edges, wf = multiband_params(sample_rate, bands)
    n = signal.shape[-1]
    bins = best_fft_length(n)
    freqs = _fft_freqs(bins, torch.float32, signal.device)
    e = torch.as_tensor(edges, dtype=torch.float32, device=signal.device)
    mags = compute_bandpass_magnitude(
        freqs[None, :], e[:-1, None], e[1:, None], wf)          # (bands, F)
    spectrum = torch.fft.rfft(signal, n=bins, dim=-1)           # (..., F)
    weighted = spectrum[..., None, :] * mags                    # (..., b, F)
    # rfft bins stand for both halves of the spectrum but DC and Nyquist;
    # the energy ratio below has that factor in numerator and denominator
    summed_squared = torch.sum(torch.abs(weighted) ** 2, dim=-1)
    integrated_envelope = torch.sum(mags, dim=-1)
    return torch.where(integrated_envelope > 0,
                       torch.sqrt(summed_squared / integrated_envelope),
                       torch.zeros_like(summed_squared))
