"""Sample-rate conversion via windowed-sinc interpolation.

Port of ``wayverb_tpu.signal.resample``: a Kaiser-windowed sinc interpolator
as one batched gather + weighted reduction, replacing the reference's
libsamplerate call (``waveguide/src/config.cpp:29-56``).  The output is
scaled by ``in_sr / out_sr`` (reference level convention).
"""

from __future__ import annotations

import torch


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50.0:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21.0:
        return 0.5842 * (att_db - 21.0) ** 0.4 + 0.07886 * (att_db - 21.0)
    return 0.0


def resample(signal, in_sr: float, out_sr: float, taps: int = 64,
             att_db: float = 80.0):
    """Resample (..., n) from ``in_sr`` to ``out_sr``.

    Output length = floor(n · out_sr / in_sr); output is scaled by
    ``in_sr/out_sr`` (reference level convention, config.cpp:49-53).
    """
    if in_sr == out_sr:
        return signal
    device = signal.device
    ratio = out_sr / in_sr
    n = signal.shape[-1]
    out_n = int(n * ratio)
    cutoff = min(1.0, ratio)  # normalized to in-rate nyquist
    beta = _kaiser_beta(att_db)

    j = torch.arange(out_n, dtype=torch.float32, device=device)
    t = j / ratio                                   # position in input samples
    base = torch.floor(t).to(torch.int32)
    frac = t - base
    k = torch.arange(-(taps // 2) + 1, taps // 2 + 1, dtype=torch.int32,
                     device=device)                                   # (K,)
    idx = base[:, None] + k[None, :]                                  # (O, K)
    valid = (idx >= 0) & (idx < n)
    idx_c = torch.clamp(idx, 0, n - 1).long()
    x = frac[:, None] - k[None, :].to(torch.float32)                  # (O, K)
    window_arg = torch.clamp(x / (taps / 2.0), -1.0, 1.0)
    window = torch.special.i0(beta * torch.sqrt(1.0 - window_arg ** 2)) \
        / torch.special.i0(torch.tensor(beta, dtype=torch.float32,
                                        device=device))
    weights = cutoff * torch.sinc(cutoff * x) * window * valid
    gathered = signal[..., idx_c]                                     # (...,O,K)
    out = torch.sum(gathered * weights, dim=-1)
    return out / ratio
