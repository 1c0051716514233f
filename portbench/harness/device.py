"""The card a run measures, and the checks that bound what a run may print."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "wayverb_tpu")


def require_cards(torch, chips: int) -> None:
    """Exit non-zero, printing no result, without ``chips`` CUDA cards."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card "
                         "and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            out.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi: {exc}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)

