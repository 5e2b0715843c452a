"""ctypes bindings for the native host runtime (the repository's
``csrc/meshio.cpp``).

Port of ``dmesh2_renderer_tpu/utils/native.py``. The source is read where it
lies and never edited; the shared library is built on demand with g++ (no
pybind11 dependency) into the port's ``csrc/build/`` (which git ignores),
under a name that hashes the source and the flags. The build writes a
temporary file of its own and renames it into place, so concurrent
processes never load a partial library. This is host code: when no source
or no compiler is present, ``load`` returns None and callers take their
pure-Python paths (``utils/meshes.py::tet_grid`` is such a path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "csrc" / "meshio.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libmeshio-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load():
    """Return the meshio ctypes library, building it if needed; None if
    unavailable (no source / no compiler)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.tet_count_faces.argtypes = [i32p, ctypes.c_int32]
            lib.tet_count_faces.restype = ctypes.c_int32
            lib.tet_build_adjacency.argtypes = [
                i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
            ]
            lib.tet_build_adjacency.restype = ctypes.c_int32
            lib.tet_grid_generate.argtypes = [
                ctypes.c_int32, ctypes.c_float, f32p, i32p,
            ]
            lib.tet_grid_generate.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _failed = True
        return _lib


def tet_adjacency(tets: np.ndarray):
    """Unique faces + adjacency of a tet mesh, natively if possible.

    Returns (faces (F,3) i32 sorted-vertex rows, face_tets (F,2) i32 -1
    padded, tet_faces (T,4) i32) or None when the native library is
    unavailable.
    """
    lib = load()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, dtype=np.int32)
    n_tets = tets.shape[0]
    n_faces = lib.tet_count_faces(tets, n_tets)
    faces = np.empty((n_faces, 3), np.int32)
    face_tets = np.empty((n_faces, 2), np.int32)
    tet_faces = np.empty((n_tets, 4), np.int32)
    wrote = lib.tet_build_adjacency(tets, n_tets, n_faces, faces, face_tets,
                                    tet_faces)
    if wrote != n_faces:
        raise RuntimeError(f"meshio wrote {wrote} faces, counted {n_faces}")
    return faces, face_tets, tet_faces


def tet_grid(res: int, extent: float):
    """Native regular tet grid; returns (verts, tets) or None."""
    lib = load()
    if lib is None:
        return None
    n1 = res + 1
    verts = np.empty((n1 * n1 * n1, 3), np.float32)
    tets = np.empty((res * res * res * 6, 4), np.int32)
    lib.tet_grid_generate(res, float(extent), verts, tets)
    return verts, tets
