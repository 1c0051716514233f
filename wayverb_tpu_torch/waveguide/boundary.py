"""Frequency-dependent boundary filter design.

Per-surface 8-band absorption → pressure reflectance → order-6 IIR magnitude
fit → Schur stability check → reflectance→impedance transform.  Host-side
float64 setup (like the reference's itpp/yulewalk path); coefficients then
feed the device-side boundary update.

Parity: reference ``waveguide/fitted_boundary.h`` (impedance transform
b' = a+b, a' = a−b normalized by a'[0] at :20-48; flat coefficients at
:72-75; fit driver at :80-104 using doubled hrtf band centres),
``waveguide/arbitrary_magnitude_filter.h`` (envelope: drop out-of-range
points, pin DC and Nyquist to zero, 256-pt linear interp),
``waveguide/stable.h`` (Schur recursion).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wayverb_tpu_torch.signal.iir_design import (design_magnitude_filter,
                                                 frequency_response, is_stable)
from wayverb_tpu_torch.signal.multiband import band_centres

CANONICAL_ORDER = 6  # 3 biquad sections (filter_structs.h:9-66)


@dataclasses.dataclass(frozen=True)
class CanonicalCoefficients:
    """Order-6 IIR numerator/denominator, ascending powers of z^-1."""

    b: np.ndarray  # (order+1,)
    a: np.ndarray  # (order+1,)


def to_impedance_coefficients(refl: CanonicalCoefficients
                              ) -> CanonicalCoefficients:
    """Reflectance filter → wall impedance filter: b' = a+b, a' = a−b,
    normalized so a'[0] = 1 (fitted_boundary.h:20-48)."""
    b = refl.a + refl.b
    a = refl.a - refl.b
    if a[0] != 0.0:
        norm = 1.0 / a[0]
        b = b * norm
        a = a * norm
    return CanonicalCoefficients(b=b, a=a)


def to_flat_coefficients(absorption: float) -> CanonicalCoefficients:
    """Frequency-independent boundary from a scalar absorption."""
    refl = float(np.sqrt(1.0 - absorption))
    b = np.zeros(CANONICAL_ORDER + 1)
    a = np.zeros(CANONICAL_ORDER + 1)
    b[0] = refl
    a[0] = 1.0
    return to_impedance_coefficients(CanonicalCoefficients(b=b, a=a))


def compute_reflectance_filter_coefficients(absorption, sample_rate: float
                                            ) -> CanonicalCoefficients:
    """Fit the order-6 reflectance filter for one surface.

    ``absorption``: (8,) band absorptions; band centres are the audible-range
    hrtf centres normalized so Nyquist = 1 (centre_hz / sample_rate · 2,
    fitted_boundary.h:82-86).
    """
    absorption = np.asarray(absorption, dtype=np.float64)
    centres = np.asarray(band_centres(absorption.shape[0]),
                         dtype=np.float64) * 2.0 / sample_rate
    reflectance = np.sqrt(1.0 - absorption)
    # Extend the in-range band targets flat to DC and Nyquist.  (The
    # reference pins both edges to ZERO reflectance —
    # arbitrary_magnitude_filter.h:66-67 — but that cliff is unfittable by
    # an order-6 IIR without overshooting |R| > 1, which makes the boundary
    # non-passive and the mesh unstable; behavioral parity is judged by the
    # in-band reflectance, and DC is handled by the postprocess DC blocker.)
    in_range = centres <= 1.0
    freqs = np.concatenate([[0.0], centres[in_range], [1.0]])
    mags = np.concatenate([[reflectance[0]], reflectance[in_range],
                           [reflectance[in_range][-1]]])
    b, a = design_magnitude_filter(freqs, mags, CANONICAL_ORDER,
                                   pin_edges_to_zero=False,
                                   max_magnitude=1.0 - _PASSIVITY_MARGIN)
    if not is_stable(a):
        raise RuntimeError("unable to generate stable boundary filter")
    b = _enforce_passivity(b, a)
    return CanonicalCoefficients(b=b, a=a)


_PASSIVITY_MARGIN = 5e-3


def _enforce_passivity(b, a) -> np.ndarray:
    """Scale the numerator so |R(ω)| ≤ 1 everywhere.

    The boundary scheme is only energy-dissipating if the reflectance filter
    is passive at EVERY frequency (|R| ≤ 1 ⟺ Re(impedance) ≥ 0); small fit
    overshoots between the target points otherwise pump energy into the mesh
    each reflection and the whole simulation diverges.  A uniform scale
    preserves the fitted shape at the cost of slightly higher broadband
    absorption.  (The reference relies on yulewalk staying under 1; it has
    no explicit guard.)
    """
    grid = np.linspace(0.0, 1.0, 4096)
    peak = np.abs(frequency_response(b, a, grid)).max()
    limit = 1.0 - _PASSIVITY_MARGIN
    if peak > limit:
        b = b * (limit / peak)
    return b


def compute_boundary_coefficients(absorption, sample_rate: float
                                  ) -> CanonicalCoefficients:
    """Full chain: absorption bands → stable impedance boundary filter."""
    return to_impedance_coefficients(
        compute_reflectance_filter_coefficients(absorption, sample_rate))


def reflectance_response(coeffs: CanonicalCoefficients, freqs_norm):
    """|reflectance| predicted by impedance coefficients at normalized freqs.

    Inverse of ``to_impedance_coefficients`` for validation: given impedance
    filter Z = B/A, reflectance filter is (B−A)/(B+A).
    """
    rb = coeffs.b - coeffs.a
    ra = coeffs.b + coeffs.a
    return np.abs(frequency_response(rb, ra, freqs_norm))


def coefficient_table(coefficients_list) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-surface coefficients into (S, order+1) b and a arrays."""
    b = np.stack([c.b for c in coefficients_list]).astype(np.float32)
    a = np.stack([c.a for c in coefficients_list]).astype(np.float32)
    return b, a
