"""The control of each cell's correctness check: the plain reference put in
the program's place, computed in bfloat16 (the precision below the
configuration's float32), or with ``--fault`` one of the faults the cell's
kind can plant in it; judged against the float32 reference by the cell's
own numbers.  The benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--fault <name>]

prints one JSON line a seed with the numbers the control reads; each must
fail at least one of the cell's limits.  No program is loaded: the inputs
come from the kind's own ``inputs``, as in the cell's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(torch, config, traffic, seed, device, fault=None):
    from portbench.harness import manifest
    kind = manifest.module("kinds", traffic["kind"])
    return kind.control(torch, kind.inputs(config, traffic, seed), device,
                        fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import check, manifest
    m = manifest.manifest()
    cell = manifest.cell(m, args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    faults = manifest.module("kinds", traffic["kind"]).FAULTS
    if args.fault is not None and args.fault not in faults:
        raise SystemExit(f"{args.fault!r} is none of {faults}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(torch, config, traffic, seed, "cuda",
                                  fault=args.fault)
        correct, _ = check.judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "control": numbers,
                          "correct": correct,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
