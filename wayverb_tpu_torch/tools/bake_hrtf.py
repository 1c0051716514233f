"""Bake an HRTF energy table from a directory of HRIR WAV files (the
reference's ``tools/bake_hrtf.py``, the equivalent of wayverb's
``src/hrtf/cmd`` code generator).

Each WAV holds one direction's stereo impulse response, named
``azel_az_<deg>_el_<deg>.wav`` (any text around the two numbers works: the
first two signed integers of the name are azimuth and elevation in degrees)
or in the IRCAM Listen convention (``IRC_…_R0195_T030_P315.wav``).  Writes an
``.npz`` with the (az_bins, el_bins, 2, 8) energy table that
``wayverb_tpu_torch.core.hrtf.table_from_energies`` reads.  The band
energies are taken on the CPU in float32, as the reference pins them.

    python -m wayverb_tpu_torch.tools.bake_hrtf HRIR_DIR OUT.npz
        [--az-bins 24] [--el-bins 9]
"""

import argparse
import os
import re

import numpy as np
import torch


def bake(hrir_dir: str, out: str, az_bins: int = 24, el_bins: int = 9,
         verbose: bool = True) -> np.ndarray:
    """Bake the (az_bins, el_bins, 2, 8) energy table; writes ``out`` .npz
    and returns the table."""
    from wayverb_tpu_torch.signal.multiband import per_band_energy
    from wayverb_tpu_torch.utils.audio import read_wav

    table = np.zeros((az_bins, el_bins, 2, 8))
    counts = np.zeros((az_bins, el_bins))

    listen_re = re.compile(r".*R([0-9]+)_T([0-9]+)_P([0-9]+).*")
    for name in sorted(os.listdir(hrir_dir)):
        if not name.lower().endswith(".wav"):
            continue
        m = listen_re.match(name)
        if m:
            # IRCAM Listen naming (the set the reference bakes,
            # src/core/src/attenuator/hrtf.cpp:68-85): R radius (cm,
            # unused), T azimuth deg, P elevation deg with negative
            # elevations wrapped above 180 (P315 = −45°)
            az_deg = float(m.group(2))
            el_deg = float(m.group(3))
            if el_deg > 180.0:
                el_deg -= 360.0
        else:
            nums = re.findall(r"-?\d+", name)
            if len(nums) < 2:
                if verbose:
                    print(f"skipping {name}: no az/el in filename")
                continue
            az_deg, el_deg = float(nums[0]), float(nums[1])
        data, sr = read_wav(os.path.join(hrir_dir, name))
        if data.shape[0] < 2:
            data = np.vstack([data, data])
        az_bin = int(round(az_deg / 360.0 * az_bins)) % az_bins
        el_bin = int(np.clip(round(el_deg / 180.0 * el_bins)
                             + el_bins // 2, 0, el_bins - 1))
        for ch in range(2):
            energy = per_band_energy(
                torch.as_tensor(data[ch], dtype=torch.float32), sr).numpy()
            table[az_bin, el_bin, ch] += energy
        counts[az_bin, el_bin] += 1

    filled = counts > 0
    table[filled] /= counts[filled][:, None, None]
    if verbose:
        print(f"baked {int(filled.sum())}/{filled.size} direction bins")
    np.savez(out, table=table)
    if verbose:
        print("wrote", out)
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("hrir_dir")
    ap.add_argument("out", help="output .npz path")
    ap.add_argument("--az-bins", type=int, default=24)
    ap.add_argument("--el-bins", type=int, default=9)
    args = ap.parse_args(argv)
    table = bake(args.hrir_dir, args.out, args.az_bins, args.el_bins)
    filled = table.sum(axis=(2, 3)) > 0
    return {"baked_bins": int(filled.sum()), "bins": int(filled.size),
            "wrote": args.out}


if __name__ == "__main__":
    main()
