"""Run one cell of the port's benchmark once, on the card, and print its
result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (from process start: imports, the CUDA context, the kernel
libraries, the program's mesh, a warm-up at the cell's own shapes) is
``setup_s``; then requests run back to back for ``--seconds``; then, with
``--trace 1``, a short slice runs under the profiler; then the plain
reference checks a sample of what the window produced.  ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.
Without the cards the cell asks for, or with JAX or the JAX package loaded
at the end, it exits non-zero and prints no result.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run_cell(torch, config, traffic, limits, per_layer, e2e, seed, seconds,
             trace, device="cuda", setup_start=None):
    """Set up, run the window, trace, check; returns the result object.
    What the traffic's kind runs and compares is ``kinds/<kind>.py``."""
    from portbench.harness import check, loops, manifest, profile, timing

    setup_start = time.perf_counter() if setup_start is None else setup_start
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    kind = manifest.module("kinds", traffic["kind"])
    inp = kind.inputs(config, traffic, seed)
    cell = kind.Cell(torch, inp, device)
    setup_s = time.perf_counter() - setup_start

    win = loops.window(cell, seconds, timed=bool(trace))
    if not win["requests"]:
        raise RuntimeError(f"no request finished inside the {seconds} s "
                           "window")
    peak = torch.cuda.max_memory_allocated() if device.startswith(
        "cuda") else 0

    ctx = {"setup_s": setup_s, "window": win, **cell.context()}
    breakdown = None
    busy_s = window_s = None
    if trace:
        steps = {}
        sl = profile.run(torch, lambda: steps.setdefault(
            "n", cell.traced_slice()))
        sl["steps"] = steps["n"]
        ctx["slice"] = sl
        intervals = [(s, e) for _, s, e in sl["ops"]]
        busy_s = timing.busy(intervals, sl["lo"], sl["hi"])
        window_s = sl["hi"] - sl["lo"]

        def label(t):
            return (timing.label_at(sl["spans"], t) or "outside any span") \
                + " / " + (profile.innermost(sl["host"], t) or "python")

        breakdown = {"device_ops": timing.top_ops(sl["ops"]),
                     "idle_gaps": timing.idle_by_label(
                         intervals, sl["lo"], sl["hi"], label)}

    # the check: the program's state goes first, then the reference runs
    held = cell.hand_over(seed)
    failed = held["unstable"]
    cell = None
    _release(torch, device)
    numbers = kind.numbers(torch, inp, held, device)
    correct, rows = check.judge(numbers, limits)

    metrics = {}
    if trace:
        for m in per_layer:
            v = manifest.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            v = manifest.module("end_to_end", m["name"]).read(ctx)
            if v is None:
                raise RuntimeError(f"{m['name']} read nothing")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(win["requests"]),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if device.startswith("cuda")
                         else "cpu",
                         "kind": torch.cuda.get_device_name(0)
                         if device.startswith("cuda") else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = busy_s
        result["device"]["window_s"] = window_s
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result


def _release(torch, device) -> None:
    import gc
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from portbench.harness import device as dev
    from portbench.harness import manifest

    m = manifest.manifest()
    cell = manifest.cell(m, args.workload)
    import torch
    dev.require_cards(torch, cell["chips"])
    print(f"card: {dev.power_limit()}", file=sys.stderr)
    result = run_cell(torch, manifest.config(cell["config"]),
                      manifest.traffic(cell["traffic"]),
                      manifest.limits(cell["name"]),
                      manifest.per_layer(m, cell["name"]),
                      manifest.end_to_end(m, cell["name"]), args.seed,
                      args.seconds, args.trace,
                      setup_start=PROCESS_START)
    result["device"]["count"] = cell["chips"]
    found = dev.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"memory_peak_bytes {result['device']['memory_peak_bytes']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(result)))
    return 0


def _finite(obj):
    """The result with every non-finite number (a check that read NaN or
    inf) as the largest float, so that the line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return sys.float_info.max
    return obj


if __name__ == "__main__":
    sys.exit(main())
