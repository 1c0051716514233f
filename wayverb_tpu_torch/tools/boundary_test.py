"""Wall reflectance measurement against the designed boundary filter (the
reference's ``tools/boundary_test.py``, after wayverb's bin/boundary_test
and bin/fitted_boundary).  Prints a CSV of frequency, measured |R|,
predicted |R| and whether the bin is valid; ``main`` returns the columns.

Method (as in the reference): run the same source twice — once in a box
with the wall under test, once in a box with that wall moved far away —
and subtract; every other wall's contribution cancels exactly, leaving the
pure reflected wave.  The incident reference is the free-field signal
measured at the image-receiver position (equal path length, so spreading
cancels in the ratio).

    python -m wayverb_tpu_torch.tools.boundary_test [--absorption 0.3] [--cpu]
"""

import argparse

import numpy as np
import torch

FS = 3333.33
# geometry: source well away from the wall (a close source measures the
# spherical-wave reflection coefficient, which sits below the plane-wave
# target for absorptive walls); record short enough that second-order
# corner paths (earliest ≈131 samples here) stay out
STEPS = 110
Y, Z = 12.0, 12.2
SRC = (4.0, 6.0, 6.1)
RCV = (2.0, 6.0, 6.1)


def _run(box, absorption: float, taps, device):
    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.kernels import gen_ricker
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.excitation import make_transparent
    from wayverb_tpu_torch.waveguide.receivers import MultiNodeReceiver
    from wayverb_tpu_torch.waveguide.sources import SoftSource

    dx = grid_spacing(Environment().speed_of_sound, 1.0 / FS)
    # anchor both runs at the receiver so their grids coincide exactly
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), absorption), dx, FS,
                              anchor=RCV, device=device)
    desc = mesh.descriptor

    ricker = gen_ricker(0.2, device="cpu").numpy()
    transparent = make_transparent(ricker, ir_steps=96)
    pulse = np.zeros(STEPS, np.float32)
    pulse[:min(transparent.size, STEPS)] = transparent[:STEPS]

    src_loc = mesh.require_inside(SRC)
    tap_locs = [mesh.require_inside(t) for t in taps]
    source = SoftSource(node_idx=int(desc.flat_index(src_loc)),
                        signal=torch.as_tensor(pulse, device=device))
    receiver = MultiNodeReceiver(node_idx=torch.as_tensor(
        [desc.flat_index(loc) for loc in tap_locs], dtype=torch.int64,
        device=device))
    out = wgrun.execute(mesh, source, receiver, STEPS)
    return out["outputs"].cpu().numpy(), mesh


def measure_wall_reflectance(absorption: float, device="cpu"):
    """(freqs, measured |R|, valid bins) of one wall at ``absorption``."""
    from wayverb_tpu_torch.core.geometry import Box

    # run 1: wall under test at x=0
    box_wall = Box((0, 0, 0), (8.0, Y, Z))
    p_wall, mesh = _run(box_wall, absorption, [RCV], device)

    # reflection plane = the boundary-node plane (one cell outside the
    # first inside node)
    lo_inside = np.argwhere(mesh.inside).min(axis=0)
    wall_x = mesh.descriptor.position((lo_inside[0] - 1, 0, 0))[0]
    image = (2.0 * wall_x - RCV[0], RCV[1], RCV[2])

    # run 2: same everything, wall moved far away (x extended)
    box_free = Box((-16.0, 0, 0), (8.0, Y, Z))
    p_free, _ = _run(box_free, absorption, [RCV, image], device)

    reflected = p_wall[:, 0] - p_free[:, 0]
    incident = p_free[:, 1]

    spec_r = np.fft.rfft(reflected)
    spec_i = np.fft.rfft(incident)
    freqs = np.fft.rfftfreq(STEPS, 1.0 / FS)
    ratio = np.abs(spec_r) / np.maximum(np.abs(spec_i), 1e-12)
    good = np.abs(spec_i) > 0.1 * np.abs(spec_i).max()
    return freqs, ratio, good


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--absorption", type=float, default=0.3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.signal.iir_design import frequency_response
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import boundary as bdry

    device = device_for(args.cpu)
    freqs, measured, good = measure_wall_reflectance(args.absorption, device)
    coeffs = bdry.compute_reflectance_filter_coefficients(
        np.full(8, args.absorption), FS)
    predicted = np.abs(frequency_response(coeffs.b, coeffs.a,
                                          freqs / (FS / 2)))
    print("freq_hz,measured,predicted,valid")
    for f, m, p, g in zip(freqs, measured, predicted, good):
        print(f"{f:.1f},{m:.4f},{p:.4f},{int(g)}")
    return {"freq_hz": freqs.tolist(), "measured": measured.tolist(),
            "predicted": predicted.tolist(),
            "valid": [bool(g) for g in good]}


if __name__ == "__main__":
    main()
