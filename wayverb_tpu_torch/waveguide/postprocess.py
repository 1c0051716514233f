"""Waveguide output → audio-rate pressure signal.

Port of ``wayverb_tpu.waveguide.postprocess``: the per-step directional
receiver output is attenuated by the capsule (gain applied in intensity,
converted back to signed pressure), multiband HRTF output is mixed down at
the mesh rate, the mesh-rate signal is resampled to the output rate, each
band is bandpassed to its valid range (width 0.1) and summed, and a 10 Hz
DC blocker finishes.

Parity: reference ``waveguide/postprocess.h:57-126`` and
``waveguide/attenuator.h``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

from wayverb_tpu_torch.core.attenuator import Null
from wayverb_tpu_torch.signal.multiband import (apply_zero_phase_magnitude,
                                                compute_bandpass_magnitude,
                                                compute_hipass_magnitude,
                                                compute_lopass_magnitude,
                                                multiband_filter_and_mixdown)
from wayverb_tpu_torch.signal.resample import resample


@dataclasses.dataclass(frozen=True)
class BandpassBand:
    """One waveguide band: receiver output + the Hz range it covers."""

    pressure: Any        # (T,)
    intensity: Any       # (T, 3)
    sample_rate: float
    valid_hz: tuple      # (lo, hi)
    stable: Any = None   # () bool tensor: no NaN/Inf during the band's run


def attenuate(method, acoustic_impedance, intensity, pressure):
    """Capsule gain in the intensity domain → signed pressure trace.

    intensity: (T, 3) instantaneous intensity vectors; pressure: (T,).
    Returns (T,) for null/microphone, (T, bands) for HRTF.
    """
    if isinstance(method, Null):
        return pressure
    att = method.attenuation(-intensity)           # (T,) or (T, bands)
    magnitude = torch.linalg.vector_norm(intensity, dim=-1)
    if att.dim() == pressure.dim():                # scalar gain per step
        i = magnitude * att * att
        return torch.copysign(torch.sqrt(i * acoustic_impedance), pressure)
    i = magnitude[:, None] * att * att
    return torch.copysign(torch.sqrt(i * acoustic_impedance),
                          pressure[:, None])


def postprocess_band(band: BandpassBand, method, acoustic_impedance,
                     output_sample_rate: float):
    """One band → attenuated, mixed down, resampled pressure at the
    output rate."""
    signal = attenuate(method, acoustic_impedance, band.intensity,
                       band.pressure)
    if signal.dim() == 2:  # HRTF: (T, bands) → mixdown at the mesh rate
        signal = multiband_filter_and_mixdown(signal.T, band.sample_rate)
    return resample(signal, band.sample_rate, output_sample_rate)


def postprocess(bands: List[BandpassBand], method, acoustic_impedance,
                output_sample_rate: float):
    """Full multi-band postprocess with per-band bandpass + DC blocking."""
    total = None
    for band in bands:
        processed = postprocess_band(band, method, acoustic_impedance,
                                     output_sample_rate)
        lo, hi = band.valid_hz
        lo_n = lo / output_sample_rate
        hi_n = hi / output_sample_rate
        processed = apply_zero_phase_magnitude(
            processed,
            lambda f, lo_n=lo_n, hi_n=hi_n: compute_bandpass_magnitude(
                f, lo_n, hi_n, 0.1) if lo_n > 0
            else compute_lopass_magnitude(f, hi_n, 0.1))
        if total is None:
            total = processed
        else:
            longer, shorter = (processed, total) \
                if processed.shape[-1] >= total.shape[-1] \
                else (total, processed)
            total = longer.clone()
            total[..., :shorter.shape[-1]] += shorter

    dc = 10.0 / output_sample_rate
    return apply_zero_phase_magnitude(
        total, lambda f: compute_hipass_magnitude(f, dc, 0.9))
