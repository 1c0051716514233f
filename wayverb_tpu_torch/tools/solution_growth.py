"""Solution-growth / artefact hunt (the reference's
``tools/solution_growth.py``, after wayverb's bin/solution_growth): inject
dirac and MLS signals as hard and soft sources into a small room and check
that the solution decays rather than grows.  Prints one JSON line per
(signal, source type), then ``{"all_decaying": ...}``; ``main`` returns
{"runs": those lines, "all_decaying": ...}.

    python -m wayverb_tpu_torch.tools.solution_growth [--time 0.5] [--cpu]
"""

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cutoff", type=float, default=500.0)
    ap.add_argument("--time", type=float, default=0.5)
    ap.add_argument("--absorption", type=float, default=0.1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from wayverb_tpu_torch.core.environment import Environment
    from wayverb_tpu_torch.core.geometry import Box
    from wayverb_tpu_torch.core.kernels import \
        generate_maximum_length_sequence
    from wayverb_tpu_torch.tools._cli import device_for
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import (
        compute_sampling_frequency, grid_spacing)
    from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
    from wayverb_tpu_torch.waveguide.sources import (HardSource, SoftSource,
                                                     impulse_signal)

    device = device_for(args.cpu)
    env = Environment()
    fs = compute_sampling_frequency(args.cutoff, 0.6)
    dx = grid_spacing(env.speed_of_sound, 1.0 / fs)
    box = Box((0, 0, 0), (5.56, 3.97, 2.81))
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), args.absorption), dx, fs,
                              device=device)
    desc = mesh.descriptor
    num_steps = int(args.time * fs)

    src_idx = int(desc.flat_index(mesh.require_inside((2.0, 1.5, 1.0))))
    rcv = NodeReceiver(node_idx=torch.tensor(
        desc.flat_index(mesh.require_inside((3.5, 2.5, 1.8))),
        device=device))

    mls = generate_maximum_length_sequence(12)[:num_steps] * 0.1
    signals = {
        "dirac": impulse_signal(num_steps, 1.0, "cpu").numpy(),
        "mls": np.pad(mls, (0, max(0, num_steps - mls.size))),
    }

    ok = True
    runs = []
    for name, sig in signals.items():
        for kind, cls in (("hard", HardSource), ("soft", SoftSource)):
            src = cls(node_idx=src_idx, signal=torch.as_tensor(
                sig, dtype=torch.float32, device=device))
            out = wgrun.execute(mesh, src, rcv, num_steps)
            p = out["outputs"].cpu().numpy()
            peak = float(np.abs(p).max())
            tail = float(np.abs(p[-num_steps // 10:]).max())
            grew = tail > peak or not bool(out["stable"])
            ok &= not grew
            line = {"signal": name, "source": kind, "peak": peak,
                    "tail_peak": tail, "tail_over_peak": tail / peak,
                    "stable": bool(out["stable"]), "grew": grew}
            runs.append(line)
            print(json.dumps(line))
    print(json.dumps({"all_decaying": ok}))
    return {"runs": runs, "all_decaying": ok}


if __name__ == "__main__":
    main()
