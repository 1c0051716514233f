"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into ``<repo>/build/lib<name>.so``, a directory git
ignores.  A library newer than its source is reused.  Building needs the
CUDA toolkit, so it happens only when a kernel is launched on a CUDA tensor,
never at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def build(name: str, force: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu``; returns (library path, compiler log).

    The log holds ptxas's register and spill report; it is empty when an
    up-to-date library was reused.
    """
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if (not force and lib.exists()
            and lib.stat().st_mtime >= src.stat().st_mtime):
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if it is missing or
    older than its source."""
    return ctypes.CDLL(str(build(name)[0]))
