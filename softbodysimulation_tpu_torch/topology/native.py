"""ctypes bridge to the native C++ topology builder (native/topology.cpp).

Builds the shared library on first use with g++ (cached next to the source);
every entry point transparently falls back to the NumPy implementations in
``edges.py`` / ``coloring.py`` if the toolchain or binary is unavailable, so
the framework never *requires* the native path — it just makes scene builds
on big meshes fast.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "topology.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libsbs_topology.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.sbs_unique_edges.restype = ctypes.c_int32
        lib.sbs_unique_edges.argtypes = [i32p, ctypes.c_int32, i32p]
        lib.sbs_hinges.restype = ctypes.c_int32
        lib.sbs_hinges.argtypes = [i32p, ctypes.c_int32, i32p]
        lib.sbs_greedy_color.restype = ctypes.c_int32
        lib.sbs_greedy_color.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p]
        lib.sbs_weld.restype = ctypes.c_int32
        lib.sbs_weld.argtypes = [f32p, ctypes.c_int32, ctypes.c_float, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unique_edges(triangles: np.ndarray) -> np.ndarray:
    lib = _load()
    tris = np.ascontiguousarray(triangles, dtype=np.int32).reshape(-1, 3)
    if lib is None:
        from . import edges as _edges

        return _edges.unique_edges(tris)
    out = np.empty((3 * len(tris), 2), dtype=np.int32)
    n = lib.sbs_unique_edges(tris, len(tris), out)
    return out[:n].copy()


def hinges(triangles: np.ndarray) -> np.ndarray:
    lib = _load()
    tris = np.ascontiguousarray(triangles, dtype=np.int32).reshape(-1, 3)
    if lib is None:
        from . import edges as _edges

        return _edges.hinges(tris)
    out = np.empty((3 * len(tris), 4), dtype=np.int32)
    n = lib.sbs_hinges(tris, len(tris), out)
    return out[:n].copy()


def greedy_color(constraints: np.ndarray, n_particles: int) -> np.ndarray:
    lib = _load()
    cons = np.ascontiguousarray(constraints, dtype=np.int32)
    cons = cons.reshape(len(cons), -1)
    if lib is None:
        from . import coloring as _coloring

        return _coloring.greedy_color(cons, n_particles)
    colors = np.empty(len(cons), dtype=np.int32)
    lib.sbs_greedy_color(cons, len(cons), cons.shape[1], n_particles, colors)
    return colors


def weld_map(vertices: np.ndarray, eps: float = 1e-4
             ) -> Tuple[np.ndarray, int]:
    """map original->welded index, plus welded count (grid-quantised, same
    scheme as edges.weld)."""
    lib = _load()
    verts = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    if lib is None:
        from . import edges as _edges

        _, _, mapping = _edges.weld(
            verts, np.zeros((0, 3), np.int32), eps)
        return mapping, int(mapping.max()) + 1 if len(mapping) else 0
    mapping = np.empty(len(verts), dtype=np.int32)
    n = lib.sbs_weld(verts, len(verts), np.float32(eps), mapping)
    return mapping, int(n)
