"""HRTF energy tables.

Port of ``wayverb_tpu.core.hrtf``.  The reference ships per-direction
2-channel 8-band energies baked from the IRCAM Listen database
(``src/hrtf/cmd/main.cpp``; table layout
``core/src/attenuator/hrtf.cpp:68-85``).  That data is not copied; the
default table is synthesized from the PUBLISHED Brown–Duda structural HRTF
model (C. P. Brown & R. O. Duda, "A structural model for binaural sound
synthesis", IEEE Trans. Speech and Audio Processing 6(5), 1998):

 * head shadow: the one-pole/one-zero spherical-head filter
   H(ω,θ) = (1 + jα(θ)ω/2ω₀)/(1 + jω/2ω₀), ω₀ = c/a, with the paper's
   azimuth law α(θ) = (1 + αmin/2) + (1 − αmin/2)·cos(θ·180°/θmin),
   αmin = 0.1, θmin = 150° (eqs. 7–8);
 * pinna reflections: the paper's five-event echo model (Table 2
   amplitudes ρ = 0.5, −1, 0.5, −0.25, 0.25 with timing
   τ = A·cos(θ/2)·sin(D·(90° − φ)) + B), whose comb magnitude carves
   the elevation-dependent high-band notches;
 * diffuse-field equalization: each ear/band is normalized by its
   power average over all directions.

Interaural TIME cues are carried by the capsule's physical ear-offset
positions (``attenuator.Hrtf.ear_position``), not by this energy table.

The table is computed once in float64 numpy, as the reference computes it,
and cached as a numpy array; ``default_hrtf_table(device=)`` hands out a
float32 tensor.  Table shape: (NUM_AZ=24, NUM_EL=9, 2 channels, 8 bands),
band energies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wayverb_tpu_torch.signal.multiband import band_centres

NUM_AZ = 24
NUM_EL = 9
NUM_CHANNELS = 2
NUM_BANDS = 8

HEAD_RADIUS = 0.0875  # metres (Brown & Duda 1998 §II.A nominal sphere)
SPEED_OF_SOUND = 340.0

# Brown & Duda 1998, eqs. 7-8
ALPHA_MIN = 0.1
THETA_MIN_DEG = 150.0

# Brown & Duda 1998, Table 2 (pinna events 2-6): amplitude rho and the
# timing-law coefficients (A, B in SAMPLES at the paper's 44.1 kHz rate;
# D dimensionless) of
# tau_k = (A_k * cos(theta/2) * sin(D_k * (90 deg - phi)) + B_k) / 44100
_PINNA = (
    # rho,   A,   B,   D
    (0.5,    1.0, 2.0, 1.0),
    (-1.0,   5.0, 4.0, 0.5),
    (0.5,    5.0, 7.0, 0.5),
    (-0.25,  5.0, 11.0, 0.5),
    (0.25,   5.0, 13.0, 0.5),
)
_PINNA_FS = 44100.0


def _head_shadow_sq(theta_deg, w):
    """|H|² of the Brown–Duda head-shadow filter at normalized
    frequency w = ω/(2ω₀); θ is the angle from the EAR axis."""
    alpha = (1.0 + ALPHA_MIN / 2.0) + (1.0 - ALPHA_MIN / 2.0) * np.cos(
        np.deg2rad(theta_deg * (180.0 / THETA_MIN_DEG)))
    return (1.0 + (alpha * w) ** 2) / (1.0 + w ** 2)


def _pinna_sq(theta_deg, phi_deg, f):
    """|1 + Σ ρ_k e^{−jωτ_k}|² of the pinna echo comb (Brown & Duda
    Table 2); θ azimuth toward the ear, φ elevation."""
    acc_re = np.ones_like(f)
    acc_im = np.zeros_like(f)
    for rho, A, B, D in _PINNA:
        tau = (A * np.cos(np.deg2rad(theta_deg) / 2.0) * np.sin(
            np.deg2rad(D * (90.0 - phi_deg))) + B) / _PINNA_FS
        acc_re = acc_re + rho * np.cos(2.0 * np.pi * f * tau)
        acc_im = acc_im - rho * np.sin(2.0 * np.pi * f * tau)
    return acc_re ** 2 + acc_im ** 2


@functools.lru_cache(maxsize=1)
def _default_table_np() -> np.ndarray:
    centres = np.asarray(band_centres(NUM_BANDS), dtype=np.float64)
    table = np.zeros((NUM_AZ, NUM_EL, NUM_CHANNELS, NUM_BANDS))

    az_angles = 2.0 * np.pi * np.arange(NUM_AZ) / NUM_AZ
    el_angles = (np.arange(NUM_EL) - NUM_EL // 2) * (np.pi / NUM_EL)

    w0 = SPEED_OF_SOUND / HEAD_RADIUS                 # ω₀ = c/a
    w = (2.0 * np.pi * centres) / (2.0 * w0)          # ω/(2ω₀)

    for ai, az in enumerate(az_angles):
        for ei, el in enumerate(el_angles):
            # incident unit vector in head coordinates (x=right, y=up,
            # z=front), matching orientation.angle_lut_indices conventions
            d = np.array([
                np.cos(el) * np.sin(az),
                np.sin(el),
                np.cos(el) * np.cos(az),
            ])
            phi_deg = np.rad2deg(el)
            for ch, ear_x in ((0, -1.0), (1, 1.0)):
                # angle from this ear's axis (0° = straight at the ear)
                c = float(np.clip(d[0] * ear_x, -1.0, 1.0))
                theta_deg = np.rad2deg(np.arccos(c))
                e = _head_shadow_sq(theta_deg, w)
                e = e * _pinna_sq(theta_deg, phi_deg, centres)
                table[ai, ei, ch] = e

    # diffuse-field equalization: unit power average over directions
    # (cos-elevation solid-angle weights) per ear per band
    wts = np.cos(el_angles)[None, :, None, None]
    dfe = (table * wts).sum(axis=(0, 1), keepdims=True) / (
        NUM_AZ * wts.sum(axis=(0, 1), keepdims=True))
    table = table / np.maximum(dfe, 1e-12)
    return table.astype(np.float32)


def default_hrtf_table(device="cpu") -> torch.Tensor:
    """(NUM_AZ, NUM_EL, 2, 8) float32 energy table on ``device``: Brown–Duda
    structural model + diffuse-field equalization (module docstring)."""
    return torch.as_tensor(_default_table_np(), device=device)


def table_from_energies(energies, device=None) -> torch.Tensor:
    """Validate/convert a baked (az, el, 2, bands) table (the reference's
    ``tools/bake_hrtf.py`` writes one) to a float32 tensor."""
    if not isinstance(energies, torch.Tensor):
        energies = np.asarray(energies)
    t = torch.as_tensor(energies, dtype=torch.float32, device=device)
    if t.dim() != 4 or t.shape[2] != NUM_CHANNELS:
        raise ValueError(
            f"expected (az, el, 2, bands) table, got {tuple(t.shape)}")
    return t
