"""ctypes bindings for the native setup runtime (native/wayverb_native.cpp).

Builds on demand with g++ (cached); everything degrades gracefully to the
pure-Python paths when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libwayverb_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "wayverb_native.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
             "-o", _LIB_PATH, src],
            check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.wv_classify_inside.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.wv_closest_triangle_surface.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.wv_version.restype = ctypes.c_int
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def classify_inside(points: np.ndarray, vertices: np.ndarray,
                    triangles: np.ndarray,
                    grid_side: int = 16) -> Optional[np.ndarray]:
    """(P,) bool inside flags via the native voxel-DDA parity vote, or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    out = np.zeros(points.shape[0], dtype=np.uint8)
    lib.wv_classify_inside(
        _ptr(points, ctypes.c_double), points.shape[0],
        _ptr(vertices, ctypes.c_double), _ptr(triangles, ctypes.c_int32),
        triangles.shape[0], grid_side, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def closest_triangle_surface(points: np.ndarray, vertices: np.ndarray,
                             triangles: np.ndarray,
                             tri_surfaces: np.ndarray
                             ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    tri_surfaces = np.ascontiguousarray(tri_surfaces, dtype=np.int32)
    out = np.zeros(points.shape[0], dtype=np.int32)
    lib.wv_closest_triangle_surface(
        _ptr(points, ctypes.c_double), points.shape[0],
        _ptr(vertices, ctypes.c_double), _ptr(triangles, ctypes.c_int32),
        _ptr(tri_surfaces, ctypes.c_int32), triangles.shape[0],
        _ptr(out, ctypes.c_int32))
    return out
