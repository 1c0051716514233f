"""Boundary filters of the plain reference: 8-band absorption to the order-6
wall impedance filter that the rectilinear waveguide's boundary nodes run.

A frozen copy of the design chain (minimum-phase target from the real
cepstrum, equation-error least squares with Sanathanan-Koerner reweighting,
pole reflection, Schur-Cohn stability test, passivity scaling, reflectance to
impedance), kept here so that the reference works the coefficients out again
from the absorption alone and does not move when the program's fit changes.
Host numpy, float64; the tables are rounded to float32 at the end.
"""

from __future__ import annotations

import numpy as np

ORDER = 6
PASSIVITY_MARGIN = 5e-3
AUDIBLE = (20.0, 20000.0)


def band_centres(bands: int) -> np.ndarray:
    """Geometric centres in Hz of ``bands`` log-spaced bands over 20 Hz to
    20 kHz."""
    lo, hi = AUDIBLE
    return np.asarray([lo * (hi / lo) ** ((2 * i + 1) / (2 * bands))
                       for i in range(bands)])


def is_stable(a) -> bool:
    a = np.asarray(a, dtype=np.float64)
    if a[0] == 0.0:
        return False
    a = a / a[0]
    while a.size > 1:
        rci = a[-1]
        if np.abs(rci) >= 1.0:
            return False
        a = (a[:-1] - a[1:][::-1] * rci) / (1.0 - rci * rci)
    return True


def minimum_phase(magnitude: np.ndarray) -> np.ndarray:
    m = np.maximum(np.asarray(magnitude, dtype=np.float64), 1e-8)
    n = m.size
    cep = np.fft.ifft(np.log(np.concatenate([m, m[-2:0:-1]]))).real
    folded = np.zeros_like(cep)
    folded[0] = cep[0]
    half = cep.size // 2
    folded[1:half] = 2.0 * cep[1:half]
    folded[half] = cep[half]
    return np.exp(np.fft.fft(folded))[:n]


def equation_error_fit(omega, h, order, weights, iterations=8):
    e = np.exp(-1j * np.outer(omega, np.arange(order + 1)))
    sk = np.ones_like(omega)
    for _ in range(iterations):
        sw = np.sqrt(weights * sk)
        lhs = np.concatenate([-e, h[:, None] * e[:, 1:]], axis=1) * sw[:, None]
        rhs = -h * sw
        sol, *_ = np.linalg.lstsq(
            np.concatenate([lhs.real, lhs.imag], axis=0),
            np.concatenate([rhs.real, rhs.imag], axis=0), rcond=None)
        b = sol[:order + 1]
        a = np.concatenate([[1.0], sol[order + 1:]])
        sk = 1.0 / np.maximum(np.abs(e @ a) ** 2, 1e-10)
    return b, a


def reflect_poles(a: np.ndarray) -> np.ndarray:
    roots = np.roots(a)
    mags = np.abs(roots)
    scale = np.prod(np.where(mags > 1.0, mags, 1.0))
    roots = np.where(mags > 1.0, 1.0 / np.conj(roots), roots)
    return np.real(np.poly(roots)) * a[0] * scale


def response(b, a, freqs):
    omega = np.asarray(freqs, dtype=np.float64) * np.pi
    e = np.exp(-1j * np.outer(omega, np.arange(max(b.size, a.size))))
    return (e[:, :b.size] @ b) / (e[:, :a.size] @ a)


def fit_magnitude(freqs, mags, order, max_magnitude, grid_points=256,
                  dense_points=512, constraint_iterations=6):
    keep = (freqs >= 0.0) & (freqs <= 1.0)
    freqs, mags = freqs[keep], mags[keep]
    order_idx = np.argsort(freqs, kind="stable")
    freqs, mags = freqs[order_idx], mags[order_idx]
    grid = np.linspace(0.0, 1.0, grid_points)
    target = np.interp(grid, freqs, mags)
    dense = np.linspace(0.0, 1.0, dense_points)
    omega = dense * np.pi

    def fit(target_on_grid, w):
        dense_target = (np.interp(dense, grid, target_on_grid)
                        if target_on_grid.shape != dense.shape
                        else target_on_grid)
        h = minimum_phase(dense_target)
        b, a = equation_error_fit(omega, h, order, w)
        if not is_stable(a):
            a = reflect_poles(a)
            e = np.exp(-1j * np.outer(omega, np.arange(order + 1)))
            ar = e @ a
            sw = np.sqrt(w)[:, None]
            m = (e / ar[:, None]) * sw
            v = h * np.sqrt(w)
            b, *_ = np.linalg.lstsq(np.concatenate([m.real, m.imag], axis=0),
                                    np.concatenate([v.real, v.imag], axis=0),
                                    rcond=None)
        return b, a

    weights = np.ones(dense_points)
    b, a = fit(target, weights)
    dense_target = np.interp(dense, grid, target)
    for _ in range(constraint_iterations):
        over = np.abs(response(b, a, dense)) > max_magnitude
        if not np.any(over):
            break
        dense_target = np.where(over, np.minimum(dense_target, max_magnitude),
                                dense_target)
        weights = np.where(over, weights * 4.0, weights)
        b, a = fit(dense_target, weights)
    return b, a


def impedance_filter(absorption, sample_rate: float):
    """(b, a) float64 of one surface's wall impedance filter: the order-6
    reflectance fit to sqrt(1 - absorption) at the band centres (flat out
    to DC and Nyquist), made passive, then b' = a + b, a' = a - b with
    a'[0] = 1."""
    absorption = np.asarray(absorption, dtype=np.float64)
    centres = band_centres(absorption.shape[0]) * 2.0 / sample_rate
    refl = np.sqrt(1.0 - absorption)
    in_range = centres <= 1.0
    freqs = np.concatenate([[0.0], centres[in_range], [1.0]])
    mags = np.concatenate([[refl[0]], refl[in_range], [refl[in_range][-1]]])
    limit = 1.0 - PASSIVITY_MARGIN
    b, a = fit_magnitude(freqs, mags, ORDER, limit)
    if not is_stable(a):
        raise RuntimeError("unable to fit a stable boundary filter")
    peak = np.abs(response(b, a, np.linspace(0.0, 1.0, 4096))).max()
    if peak > limit:
        b = b * (limit / peak)
    zb, za = a + b, a - b
    if za[0] != 0.0:
        zb, za = zb / za[0], za / za[0]
    return zb, za


def coefficient_tables(absorptions, sample_rate: float):
    """(S, order+1) float32 numerator and denominator tables, one row a
    surface."""
    rows = [impedance_filter(a, sample_rate) for a in absorptions]
    return (np.stack([r[0] for r in rows]).astype(np.float32),
            np.stack([r[1] for r in rows]).astype(np.float32))
