"""Decay analysis: Schroeder integration, line fits, reverb times.

Port of the decay half of ``wayverb_tpu.signal.filters``.  The DF2T
``iir_filter`` scan waits for the slice that needs it.

Parity: reference ``core/schroeder.h`` (backwards-integrated decay),
``core/linear_regression.h``.
"""

from __future__ import annotations

import torch


def linear_regression(x, y):
    """Least-squares line fit; returns (slope, intercept) over last axis."""
    mx = torch.mean(x, dim=-1, keepdim=True)
    my = torch.mean(y, dim=-1, keepdim=True)
    num = torch.sum((x - mx) * (y - my), dim=-1)
    den = torch.sum(torch.square(x - mx), dim=-1)
    slope = num / den
    intercept = my[..., 0] - slope * mx[..., 0]
    return slope, intercept


def schroeder_integral(signal):
    """Backwards-integrated squared decay curve (not dB)."""
    sq = torch.square(signal)
    return torch.flip(torch.cumsum(torch.flip(sq, dims=(-1,)), dim=-1),
                      dims=(-1,))


def decay_time(signal, sample_rate, begin_db=-5.0, end_db=-25.0,
               full_range_db=60.0):
    """Reverb time by Schroeder integration + line fit between two levels.

    ``begin_db``/``end_db`` of (-5, -25) gives T20-extrapolated-to-60,
    (-5, -35) gives T30.  The window selection carries no gradient.
    """
    curve = schroeder_integral(signal)
    db = 10.0 * torch.log10(torch.clamp(curve / curve[..., :1], min=1e-30))
    mask = (db <= begin_db) & (db >= end_db)
    t = torch.arange(signal.shape[-1], dtype=signal.dtype,
                     device=signal.device) / sample_rate
    w = mask.to(signal.dtype).detach()
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mx = torch.sum(w * t, dim=-1) / n
    my = torch.sum(w * db, dim=-1) / n
    num = torch.sum(w * (t - mx[..., None]) * (db - my[..., None]), dim=-1)
    den = torch.sum(w * torch.square(t - mx[..., None]), dim=-1)
    slope = num / torch.clamp(den, min=1e-30)  # dB per second (negative)
    return -full_range_db / slope
