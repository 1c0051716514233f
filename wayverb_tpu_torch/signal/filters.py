"""Time-domain filters and decay analysis.

Port of ``wayverb_tpu.signal.filters``.  IIR filtering runs a direct-form-II
transposed state through a per-sample Python loop (the reference's
``lax.scan``), the same recurrence as the waveguide's boundary filters
(``waveguide/cl/filters.cpp``: ``filter_step_canonical``).  The module is
the package's filtering and decay analysis for its users (``rt60_measures``
reads EDT, T20 and T30 off a rendered IR); no path of the engine calls it,
so it is plain torch.

Parity: reference ``core/filters_common.h`` (biquad), ``core/dc_blocker.h``,
``core/schroeder.h`` (backwards-integrated decay),
``core/linear_regression.h``.
"""

from __future__ import annotations

import torch


def filter_step(x, state, b, a):
    """One DF2T step (the waveguide kernel's ``filter_step_canonical``).

    Returns (y, new_state); everything broadcasts over leading axes with the
    state's trailing axis = order.
    """
    y = (x * b[..., 0] + state[..., 0]) / a[..., 0]
    shifted = torch.cat([state[..., 1:], torch.zeros_like(state[..., :1])],
                        dim=-1)
    new_state = shifted + b[..., 1:] * x[..., None] \
        - a[..., 1:] * y[..., None]
    return y, new_state


def iir_filter(b, a, x, state=None):
    """Direct-form-II-transposed IIR along the last axis of ``x``.

    ``b``/``a``: (order+1,) with ``a[0]`` the normalizer.  Differentiable in
    both the signal and the coefficients.  Returns (y, final_state).
    """
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    order = b.shape[0] - 1
    if state is None:
        state = torch.zeros(x.shape[:-1] + (order,), dtype=x.dtype,
                            device=x.device)
    ys = []
    for n in range(x.shape[-1]):
        y, state = filter_step(x[..., n], state, b, a)
        ys.append(y)
    return torch.stack(ys, dim=-1), state


def biquad_cascade(sections_b, sections_a, x):
    """Cascade of biquads (S, 3) applied serially (reference biquad chain)."""
    y = x
    for i in range(sections_b.shape[0]):
        y, _ = iir_filter(sections_b[i], sections_a[i], y)
    return y


def dc_blocker_coefficients(r=0.995):
    """y[n] = x[n] - x[n-1] + R y[n-1]  (reference dc_blocker.h)."""
    return torch.tensor([1.0, -1.0, 0.0]), torch.tensor([1.0, -r, 0.0])


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


def rt60_measures(signal, sample_rate):
    """Common measures dict: EDT, T20, T30 from one IR."""
    return {
        "edt": decay_time(signal, sample_rate, 0.0, -10.0, 60.0),
        "t20": decay_time(signal, sample_rate, -5.0, -25.0, 60.0),
        "t30": decay_time(signal, sample_rate, -5.0, -35.0, 60.0),
    }
