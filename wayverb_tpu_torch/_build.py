"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into ``<repo>/build/lib<name>.so``, a directory git
ignores.  A library newer than its source and the shared headers
(``csrc/*.cuh``) is reused.  ``--fmad=false``: every product and sum rounds
on its own, as in the kernels' plain torch versions.  Building needs the
CUDA toolkit, so it happens only when a kernel is launched on a CUDA tensor,
never at import.  A library's first load is a ``kernels.load:<name>``
span and a compilation a ``kernels.build:<name>`` span
(``utils.events.span``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from wayverb_tpu_torch.utils import events

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
    newest = max(p.stat().st_mtime
                 for p in (src, *CSRC_DIR.glob("*.cuh")))
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    with events.span(f"kernels.build:{name}"):
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
    with events.span(f"kernels.load:{name}"):
        return ctypes.CDLL(str(build(name)[0]))


@functools.cache
def load_entry(name: str, entry: str, n_pointers: int) -> ctypes.CDLL:
    """Library ``name`` with its function ``entry`` declared as
    (``n_pointers`` pointers, three ints, the stream) → CUDA error code, and
    its ``wv_cuda_error_string`` declared."""
    lib = load(name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib
