"""Magnitude-only IIR design: fit an order-N filter to a target magnitude
response. Host-side numpy float64 (setup path, like the reference's use of
itpp's yulewalk); the resulting coefficients feed the device-side boundary
filters.

Algorithm (own construction, replacing itpp::yulewalk):
 1. build a minimum-phase complex response from the target magnitude via the
    real cepstrum (Hilbert transform of log-magnitude),
 2. solve the equation-error least-squares problem
    min Σ w(ω) |A(ω) H(ω) − B(ω)|² (Levy's method) with a few
    Sanathanan–Koerner reweighting iterations,
 3. reflect any unstable poles inside the unit circle (magnitude-preserving
    up to a constant, which is re-absorbed into b),
 4. verify with the Schur–Cohn recursion.

Parity targets: reference ``waveguide/arbitrary_magnitude_filter.h`` (256-pt
linear-interp envelope grid, endpoints pinned to zero amplitude),
``waveguide/stable.h:29-50`` (Schur stability test).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def is_stable(a) -> bool:
    """Schur–Cohn recursion on denominator coefficients (ascending powers of
    z^-1, a[0] first).  Matches reference ``stable.h``."""
    a = np.asarray(a, dtype=np.float64)
    if a[0] == 0.0:
        return False
    a = a / a[0]  # recursion assumes a monic denominator
    while a.size > 1:
        rci = a[-1]
        if np.abs(rci) >= 1.0:
            return False
        a = (a[:-1] - a[1:][::-1] * rci) / (1.0 - rci * rci)
    return True


def minimum_phase_response(magnitude_grid: np.ndarray) -> np.ndarray:
    """Minimum-phase complex response from magnitude samples on a uniform
    one-sided grid [0, π] (inclusive).  Uses the real-cepstrum method."""
    m = np.maximum(np.asarray(magnitude_grid, dtype=np.float64), 1e-8)
    n = m.size
    full = np.concatenate([m, m[-2:0:-1]])          # even extension, 2n-2 pts
    log_mag = np.log(full)
    cep = np.fft.ifft(log_mag).real
    # fold the cepstrum: double positive quefrencies, zero negative ones
    folded = np.zeros_like(cep)
    folded[0] = cep[0]
    half = cep.size // 2
    folded[1:half] = 2.0 * cep[1:half]
    folded[half] = cep[half]
    return np.exp(np.fft.fft(folded))[:n]


def eqnerror_fit(freqs: np.ndarray, response: np.ndarray, order: int,
                 weights: np.ndarray | None = None,
                 sk_iterations: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Fit B(z)/A(z) of equal order to complex ``response`` at ``freqs``
    (radians/sample).  Returns (b, a) with a[0]=1."""
    freqs = np.asarray(freqs, dtype=np.float64)
    h = np.asarray(response, dtype=np.complex128)
    w0 = np.ones_like(freqs) if weights is None else np.asarray(weights)
    k = np.arange(order + 1)
    e = np.exp(-1j * np.outer(freqs, k))            # (F, order+1)

    a = np.zeros(order + 1)
    a[0] = 1.0
    sk = np.ones_like(freqs)
    b = None
    for _ in range(max(sk_iterations, 1)):
        w = w0 * sk
        # unknowns: b[0..N], a[1..N];   A(ω)H(ω) − B(ω) ≈ 0
        lhs = np.concatenate([-e, (h[:, None] * e[:, 1:])], axis=1)
        rhs = -h
        ww = np.sqrt(w)[:, None]
        m = np.concatenate([(lhs * ww).real, (lhs * ww).imag], axis=0)
        v = np.concatenate([(rhs * np.sqrt(w)).real,
                            (rhs * np.sqrt(w)).imag], axis=0)
        sol, *_ = np.linalg.lstsq(m, v, rcond=None)
        b = sol[:order + 1]
        a = np.concatenate([[1.0], sol[order + 1:]])
        a_resp = e @ a
        sk = 1.0 / np.maximum(np.abs(a_resp) ** 2, 1e-10)
    return b, a


def levinson(r: np.ndarray, order: int) -> np.ndarray:
    """Levinson–Durbin: monic, stable AR(order) coefficients from
    autocorrelation r[0..order]."""
    a = np.array([1.0])
    err = r[0]
    for i in range(1, order + 1):
        acc = r[i] + (np.dot(a[1:], r[1:i][::-1]) if i > 1 else 0.0)
        k = -acc / err
        a = np.concatenate([a, [0.0]])
        a = a + k * a[::-1]
        err = err * (1.0 - k * k)
        if err <= 1e-16:
            break
    if a.size < order + 1:
        a = np.concatenate([a, np.zeros(order + 1 - a.size)])
    return a


def yulewalk_design(freqs_norm, magnitudes, order: int,
                    npt: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Magnitude-only IIR fit in the style of MATLAB/itpp ``yulewalk``.

    Denominator: Levinson–Durbin AR model of the target power spectrum
    (autocorrelation method — inherently stable, smooths rather than
    overshoots sharp transitions).  Numerator: linear least squares against
    the minimum-phase target with the denominator fixed.
    """
    freqs = np.asarray(freqs_norm, dtype=np.float64)
    mags = np.asarray(magnitudes, dtype=np.float64)
    grid = np.linspace(0.0, 1.0, npt)
    target = np.interp(grid, freqs, mags)

    power = target ** 2
    full = np.concatenate([power, power[-2:0:-1]])
    r = np.fft.ifft(full).real[:order + 1]
    a = levinson(r, order)

    h_min = minimum_phase_response(target)
    omega = grid * np.pi
    k = np.arange(order + 1)
    e = np.exp(-1j * np.outer(omega, k))
    a_resp = e @ a
    target_b = a_resp * h_min
    m = np.concatenate([e.real, e.imag], axis=0)
    v = np.concatenate([target_b.real, target_b.imag], axis=0)
    b, *_ = np.linalg.lstsq(m, v, rcond=None)
    return b, a


def polystab(a: np.ndarray) -> np.ndarray:
    """Reflect roots of the polynomial outside the unit circle to their
    conjugate-reciprocal positions (magnitude response scaled by a constant)."""
    a = np.asarray(a, dtype=np.float64)
    if a.size <= 1:
        return a
    roots = np.roots(a)
    mags = np.abs(roots)
    scale = np.prod(np.where(mags > 1.0, mags, 1.0))
    roots = np.where(mags > 1.0, 1.0 / np.conj(roots), roots)
    out = np.real(np.poly(roots)) * a[0] * scale
    return out


def design_magnitude_filter(freqs_norm, magnitudes, order: int,
                            grid_points: int = 256,
                            pin_edges_to_zero: bool = True,
                            dense_points: int = 512,
                            max_magnitude: float | None = None,
                            constraint_iterations: int = 6):
    """Fit an order-N IIR to magnitude points.

    ``freqs_norm``: frequencies normalized so Nyquist = 1, ascending;
    points outside [0, 1] are dropped.  ``pin_edges_to_zero`` appends
    zero-amplitude points at DC and Nyquist exactly like the reference's
    envelope construction (``arbitrary_magnitude_filter.h:63-81``), then the
    envelope is linearly interpolated onto a uniform ``grid_points`` grid.

    Returns (b, a) float64 arrays of length order+1, a stable.
    """
    freqs = np.asarray(freqs_norm, dtype=np.float64)
    mags = np.asarray(magnitudes, dtype=np.float64)
    keep = (freqs >= 0.0) & (freqs <= 1.0)
    freqs, mags = freqs[keep], mags[keep]
    if pin_edges_to_zero:
        freqs = np.concatenate([[0.0], freqs, [1.0]])
        mags = np.concatenate([[0.0], mags, [0.0]])
    srt = np.argsort(freqs, kind="stable")
    freqs, mags = freqs[srt], mags[srt]

    grid = np.linspace(0.0, 1.0, grid_points)
    target = np.interp(grid, freqs, mags)

    # densify for the cepstral minimum-phase construction
    dense_grid = np.linspace(0.0, 1.0, dense_points)
    weights = np.ones(dense_points)

    def fit(target_on_grid, w):
        dense_target = np.interp(dense_grid, grid, target_on_grid) \
            if target_on_grid.shape != dense_grid.shape else target_on_grid
        h_min = minimum_phase_response(dense_target)
        omega = dense_grid * np.pi
        b, a = eqnerror_fit(omega, h_min, order, weights=w)
        if not is_stable(a):
            a = polystab(a)
            k = np.arange(order + 1)
            e = np.exp(-1j * np.outer(omega, k))
            a_resp = e @ a
            ww = np.sqrt(w)[:, None]
            m = np.concatenate([((e / a_resp[:, None]) * ww).real,
                                ((e / a_resp[:, None]) * ww).imag], axis=0)
            v = np.concatenate([(h_min * np.sqrt(w)).real,
                                (h_min * np.sqrt(w)).imag], axis=0)
            b, *_ = np.linalg.lstsq(m, v, rcond=None)
        return b, a

    b, a = fit(target, weights)
    if max_magnitude is not None:
        # iteratively push overshoot regions back under the ceiling: clip the
        # dense target where the fit exceeds it and upweight those samples
        dense_target = np.interp(dense_grid, grid, target)
        for _ in range(constraint_iterations):
            h = np.abs(frequency_response(b, a, dense_grid))
            over = h > max_magnitude
            if not np.any(over):
                break
            dense_target = np.where(
                over, np.minimum(dense_target, max_magnitude), dense_target)
            weights = np.where(over, weights * 4.0, weights)
            b, a = fit(dense_target, weights)
    return b, a


def frequency_response(b, a, freqs_norm):
    """|H| and phase at normalized frequencies (Nyquist=1)."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    omega = np.asarray(freqs_norm, dtype=np.float64) * np.pi
    k = np.arange(max(b.size, a.size))
    e = np.exp(-1j * np.outer(omega, k))
    return (e[:, :b.size] @ b) / (e[:, :a.size] @ a)
