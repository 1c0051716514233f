"""Boundary-filter fit quality over every preset material and mesh rate (the
reference's ``tools/boundary_fit_sweep.py``, the ``bin/fitted_boundary``
analogue).

For every material of ``combined/model.MATERIAL_PRESETS`` at three waveguide
mesh rates, fit the order-6 impedance boundary filter
(``waveguide/boundary.py``: equation error, cepstral minimum phase, Schur
and a passivity guard) and record

 * the worst in-band |R| error against the target per-band reflectance, and
 * the largest reflectance over a dense frequency sweep (passivity: it must
   stay at or below 1).

The fit is host numpy, so the tool runs on the host and takes no ``--cpu``.
``--json`` writes the summary to the path the caller names; ``main``
returns it.

    python -m wayverb_tpu_torch.tools.boundary_fit_sweep [--json PATH]
"""

import argparse
import json

import numpy as np

MESH_RATES = [2000.0, 3333.33, 6666.67]   # waveguide cutoffs 300–1000 Hz


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.combined.model import MATERIAL_PRESETS
    from wayverb_tpu_torch.signal.multiband import band_centres
    from wayverb_tpu_torch.waveguide import boundary as bdry

    rows = []
    for preset in MATERIAL_PRESETS:
        absorption = np.asarray(preset.absorption, dtype=np.float64)
        target_r = np.sqrt(np.clip(1.0 - absorption, 0.0, 1.0))
        for fs in MESH_RATES:
            coeffs = bdry.compute_boundary_coefficients(absorption, fs)
            centres = band_centres(absorption.shape[0])
            nyq = fs / 2.0
            in_band = centres < nyq * 0.9
            freqs = centres[in_band] / nyq
            got_r = bdry.reflectance_response(coeffs, freqs)
            err = float(np.max(np.abs(got_r - target_r[in_band])))
            dense = np.linspace(1e-3, 0.999, 512)
            max_r = float(np.max(bdry.reflectance_response(coeffs, dense)))
            rows.append({
                "material": preset.name, "mesh_rate_hz": fs,
                "bands_in_range": int(in_band.sum()),
                "max_inband_r_error": err,
                "max_reflectance": max_r,
            })

    worst_err = max(r["max_inband_r_error"] for r in rows)
    worst_r = max(r["max_reflectance"] for r in rows)
    summary = {
        "materials": len(MATERIAL_PRESETS),
        "mesh_rates": MESH_RATES,
        "worst_inband_r_error": worst_err,
        "worst_reflectance": worst_r,
        "error_bound": 0.02,
        "passivity_bound": 1.0,
        "rows": rows,
    }
    print(f"{len(rows)} fits: worst in-band |R| error {worst_err:.4f}, "
          f"global max |R| {worst_r:.6f}")
    assert worst_r <= 1.0 + 1e-6, "passivity violated"
    assert worst_err <= summary["error_bound"], "fit error beyond bound (0.02)"
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print("wrote", args.json)
    return summary


if __name__ == "__main__":
    main()
