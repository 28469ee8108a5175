"""ctypes loader for the native marching-tetrahedra extractor.

The C++ core (``native/marching_tet.cpp``) implements the identical
decomposition/case logic as the vectorized numpy path in ``marching.py`` —
the numpy path is the correctness oracle, the native path the fast default
for large grids (single pass, deduplicated vertices, no big intermediate
index tensors).  Built from source by ``scripts/build_native.sh`` into the
git-ignored ``levelsetpy_tpu/_native/``, on first use or by running that
script; absent when the build cannot run (no compiler), and callers then
fall back to numpy.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np

__all__ = ["native_available", "marching_tetrahedra_native", "build"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SO = _PKG / "_native" / "libmarching.so"
_SCRIPT = _PKG.parent / "scripts" / "build_native.sh"

_LIB = None
_TRIED = False


def build() -> bool:
    """Compile the extractor from ``native/marching_tet.cpp``; True when
    the library exists afterwards."""
    if not _SO.exists() and _SCRIPT.exists() and shutil.which("g++"):
        subprocess.run(["bash", str(_SCRIPT)], check=True,
                       capture_output=True, timeout=300)
    return _SO.exists()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not build():
            return None
    except subprocess.SubprocessError:
        return None
    so = _SO
    lib = ctypes.CDLL(str(so))
    lib.marching_tet.restype = ctypes.c_int
    lib.marching_tet.argtypes = [
        ctypes.POINTER(ctypes.c_double),          # phi
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double,                          # level
        ctypes.POINTER(ctypes.c_double),          # spacing[3]
        ctypes.POINTER(ctypes.c_double),          # origin[3]
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.marching_tet_free.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def marching_tetrahedra_native(phi: np.ndarray, level: float = 0.0,
                               spacing=None, origin=None):
    """Native-path equivalent of ``marching.marching_tetrahedra``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native extractor not built; run scripts/build_native.sh")
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    nx, ny, nz = phi.shape
    spacing = np.ascontiguousarray(
        np.ones(3) if spacing is None else spacing, dtype=np.float64)
    origin = np.ascontiguousarray(
        np.zeros(3) if origin is None else origin, dtype=np.float64)

    verts_p = ctypes.POINTER(ctypes.c_double)()
    faces_p = ctypes.POINTER(ctypes.c_int64)()
    n_verts = ctypes.c_int64()
    n_faces = ctypes.c_int64()
    rc = lib.marching_tet(
        phi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nx, ny, nz, float(level),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(faces_p), ctypes.byref(n_faces))
    if rc != 0:
        raise MemoryError("native marching_tet allocation failed")
    try:
        nv, nf = n_verts.value, n_faces.value
        verts = np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() \
            if nv else np.zeros((0, 3))
        faces = np.ctypeslib.as_array(faces_p, shape=(nf, 3)).copy() \
            if nf else np.zeros((0, 3), dtype=np.int64)
    finally:
        lib.marching_tet_free(verts_p, faces_p)
    return verts, faces
