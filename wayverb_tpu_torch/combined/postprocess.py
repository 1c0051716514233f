"""Hybrid combination: crossover the waveguide (low) and geometric (high)
outputs, then window out pre-arrival junk.

Port of ``wayverb_tpu.combined.postprocess`` (parity: reference
``combined/postprocess.h:33-136`` — zero-phase lopass/hipass pair at the
waveguide's top frequency with width 0.2, sum, then a rising half-Hann
window up to the direct arrival time).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from wayverb_tpu_torch.signal.multiband import (apply_zero_phase_magnitude,
                                                compute_hipass_magnitude,
                                                compute_lopass_magnitude)
from wayverb_tpu_torch.signal.windows import left_hanning

CROSSOVER_WIDTH = 0.2  # "wider = more natural-sounding"


def crossover_filter(low_signal, high_signal, cutoff_norm: float,
                     width: float = CROSSOVER_WIDTH):
    """Zero-phase complementary crossover; signals may differ in length."""
    n = max(low_signal.shape[-1], high_signal.shape[-1])
    low = F.pad(low_signal, (0, n - low_signal.shape[-1]))
    high = F.pad(high_signal, (0, n - high_signal.shape[-1]))
    lo = apply_zero_phase_magnitude(
        low, lambda f: compute_lopass_magnitude(f, cutoff_norm, width))
    hi = apply_zero_phase_magnitude(
        high, lambda f: compute_hipass_magnitude(f, cutoff_norm, width))
    return lo + hi


def window_direct_arrival(signal, source_position, receiver_position,
                          sample_rate: float, speed_of_sound: float):
    """Half-Hann fade-in to the direct arrival (removes DC-ish pre-ring)."""
    f32 = lambda p: torch.as_tensor(p, dtype=torch.float32)  # noqa: E731
    distance = torch.linalg.vector_norm(f32(receiver_position).cpu()
                                        - f32(source_position).cpu())
    n = int(math.floor(float(distance * sample_rate / speed_of_sound)))
    n = min(n, signal.shape[-1])
    if n == 0:
        return signal
    window = left_hanning(n, signal.device)
    return torch.cat([signal[..., :n] * window, signal[..., n:]], dim=-1)
